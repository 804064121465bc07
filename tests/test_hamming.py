"""Hamming-mode (int8 matmul) ranking: oracle exactness and recall dominance."""

from __future__ import annotations

import numpy as np
import pytest

from lshrs_tpu import LSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.device import DeviceStore

B, R, D = 4, 8, 32
P = B * R


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def bits_of(words, hasher):
    """Unpack to 0/1 bit matrix using the reference packing layout."""
    n = words.shape[0]
    out = np.zeros((n, P), np.uint8)
    for j in range(P):
        band, row = j // R, j % R
        word, bit = row // 32, row % 32
        out[:, j] = (words[:, band * hasher.words_per_band + word] >> bit) & 1
    return out


def test_hamming_topk_matches_oracle(hasher, rng):
    store = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    n = 500
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(30_000)[:n]
    words = hasher.hash_batch_words_host(X)
    store.add_signature_batch(ids, words)

    queries = rng.standard_normal((10, D)).astype(np.float32)
    qw = hasher.hash_batch_words_host(queries)
    hamming, out_ids = store.query_hamming(qw, 15)

    xb = bits_of(words, hasher).astype(np.int32)
    qb = bits_of(qw, hasher).astype(np.int32)
    for qi in range(10):
        h = np.abs(xb - qb[qi]).sum(axis=1)
        expected = sorted(zip(h.tolist(), ids.tolist()))[:15]
        got = list(zip(hamming[qi].tolist(), out_ids[qi].tolist()))
        assert got == expected, f"query {qi}"


def test_hamming_after_mutations(hasher, rng):
    store = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    X = rng.standard_normal((100, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store.add_signature_batch(np.arange(100), words)

    h, out = store.query_hamming(words[5:6], 1)
    assert out[0][0] == 5 and h[0][0] == 0  # exact self-match

    store.remove_indices([5])
    h, out = store.query_hamming(words[5:6], 3)
    assert 5 not in out[0]

    # upsert keeps bitplanes in sync
    x_new = rng.standard_normal((1, D)).astype(np.float32)
    w_new = hasher.hash_batch_words_host(x_new)
    store.add_signature_batch([7], w_new)
    h, out = store.query_hamming(w_new, 1)
    assert out[0][0] == 7 and h[0][0] == 0


def test_orchestrator_query_hamming(rng):
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R,
        backend="device", enable_hamming=True,
        chunk_size=64, initial_capacity=64,
    )
    X = rng.standard_normal((80, D)).astype(np.float32)
    lsh.index(list(range(80)), X)
    out = lsh.query_hamming(X[42], top_k=5)
    assert out[0][0] == 42
    assert abs(out[0][1] - 1.0) < 1e-9  # hamming 0 -> cos estimate 1.0
    scores = [s for _, s in out]
    assert scores == sorted(scores, reverse=True)

    # the parity engine keeps Hamming mode gated (the auto engine
    # default opens it at zero cost via packed storage)
    plain = LSHRS(dim=D, num_perm=P, num_bands=B, rows_per_band=R,
                  backend="device", chunk_size=64, initial_capacity=64,
                  engine="collision")
    with pytest.raises(RuntimeError, match="enable_hamming"):
        plain.index([0], X[:1]) or plain.query_hamming(X[0])


def test_hamming_recall_dominates_collision(rng):
    """At equal memory, full-signature Hamming ranking should beat
    band-collision counting for recall@k on clustered data."""
    n, k = 400, 10
    centers = rng.standard_normal((40, D)).astype(np.float32)
    X = (centers[rng.integers(0, 40, n)] +
         0.4 * rng.standard_normal((n, D))).astype(np.float32)
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R,
        backend="device", enable_hamming=True,
        chunk_size=64, initial_capacity=512,
    )
    lsh.index(list(range(n)), X)

    xn = X / np.linalg.norm(X, axis=1, keepdims=True)
    queries = X[:50] + 0.05 * rng.standard_normal((50, D)).astype(np.float32)
    hits_h = hits_c = 0
    for q in queries:
        qn = q / np.linalg.norm(q)
        gt = set(np.argsort(-(xn @ qn))[:k].tolist())
        ham = {i for i, _ in lsh.query_hamming(q, top_k=k)}
        col = set(lsh.get_top_k(q, topk=k))
        hits_h += len(gt & ham)
        hits_c += len(gt & col)
    assert hits_h >= hits_c, (hits_h, hits_c)
    assert hits_h / (50 * k) > 0.5


def test_sharded_hamming(rng):
    import jax

    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    h = LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)
    st = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    n = 200
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(9999)[:n]
    words = h.hash_batch_words_host(X)
    st.add_signature_batch(ids, words)

    hamming, out = st.query_hamming(words[:3], 5)
    xb = bits_of(words, h).astype(np.int32)
    for qi in range(3):
        hh = np.abs(xb - xb[qi]).sum(axis=1)
        expected = sorted(zip(hh.tolist(), ids.tolist()))[:5]
        got = list(zip(hamming[qi].tolist(), out[qi].tolist()))
        assert got == expected


def test_hamming_pallas_interpret_matches_xla(hasher, rng):
    """The GPU group-max kernel (Triton route, interpret mode) == XLA path."""
    import jax.numpy as jnp

    from lshrs_tpu.ops.hamming import hamming_topk, unpack_bitplanes
    from lshrs_tpu.ops.scan import compute_global_tie

    c = 512
    X = rng.standard_normal((300, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    ids = np.full(c, -1, np.int32)
    ids[:300] = rng.permutation(4000)[:300]
    sig_t = np.zeros((hasher.words_per_band * B, c), np.uint32)
    sig_t[:, :300] = words.T
    tie = compute_global_tie(jnp.asarray(ids))
    planes = unpack_bitplanes(
        jnp.asarray(sig_t.T.copy()), num_bands=B, rows_per_band=R
    )
    qw = hasher.hash_batch_words_host(rng.standard_normal((6, D)).astype(np.float32))
    qbits = unpack_bitplanes(jnp.asarray(qw), num_bands=B, rows_per_band=R)

    kw = dict(k=12, chunk=128, group=32)
    h1, i1 = hamming_topk(
        planes, jnp.asarray(sig_t), jnp.asarray(ids), tie, qbits, jnp.asarray(qw),
        **kw,
    )
    h2, i2 = hamming_topk(
        planes, jnp.asarray(sig_t), jnp.asarray(ids), tie, qbits, jnp.asarray(qw),
        kernel="interpret", **kw,
    )
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_query_hamming_batch_matches_single(rng):
    from lshrs_tpu import LSHRS

    lsh = LSHRS(
        dim=24, num_perm=16, num_bands=4, rows_per_band=4,
        backend="device", chunk_size=128, initial_capacity=128,
        enable_hamming=True,
    )
    X = rng.standard_normal((40, 24)).astype(np.float32)
    lsh.index(list(range(40)), X)
    batch = lsh.query_hamming_batch(X[:5], top_k=3)
    for qi in range(5):
        assert batch[qi] == lsh.query_hamming(X[qi], top_k=3)

    import pytest

    with pytest.raises(ValueError, match="top_k"):
        lsh.query_hamming_batch(X[:2], top_k=0)
    bucket = LSHRS(dim=24, num_perm=16, num_bands=4, rows_per_band=4,
                   backend="memory")
    with pytest.raises(RuntimeError, match="device backend"):
        bucket.query_hamming_batch(X[:2], top_k=3)


def test_packed_hamming_matches_planes(rng):
    """hamming_storage='packed' (zero extra memory) must be bit-identical
    to the bitplane formulation."""
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    h = LSHHasher(num_bands=4, rows_per_band=8, dim=32, seed=3)
    kw = dict(num_bands=4, rows_per_band=8, chunk_size=128, initial_capacity=512,
              enable_hamming=True)
    planes = DeviceStore(hamming_storage="planes", **kw)
    packed = DeviceStore(hamming_storage="packed", **kw)
    assert packed._planes is None  # genuinely no bitplane array
    X = rng.standard_normal((300, 32)).astype(np.float32)
    ids = rng.permutation(10_000)[:300]
    words = h.hash_batch_words_host(X)
    planes.add_signature_batch(ids, words)
    packed.add_signature_batch(ids, words)

    qw = h.hash_batch_words_host(rng.standard_normal((11, 32)).astype(np.float32))
    h1, i1 = planes.query_hamming(qw, 9)
    h2, i2 = packed.query_hamming(qw, 9)
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(i1, i2)

    # snapshot serving closure, packed
    dense_q = rng.standard_normal((6, 32)).astype(np.float32)
    dq = h.hash_batch_dense_host(dense_q)
    s1 = np.asarray(planes.snapshot_query_fn(5, wire="dense", mode="hamming")(dq))
    s2 = np.asarray(packed.snapshot_query_fn(5, wire="dense", mode="hamming")(dq))
    np.testing.assert_array_equal(s1, s2)

    # stats report the footprint difference
    assert planes.stats()["hamming_plane_bytes"] > 0
    assert packed.stats()["hamming_plane_bytes"] == 0

    with pytest.raises(ValueError, match="hamming_storage"):
        DeviceStore(num_bands=4, rows_per_band=8, hamming_storage="sparse")


def test_packed_hamming_chunked_fallback(rng):
    """Packed chunked path (grouped key would not fit int32) matches the
    planes chunked path."""
    import lshrs_tpu.storage.device as device_mod
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    h = LSHHasher(num_bands=4, rows_per_band=8, dim=32, seed=5)
    kw = dict(num_bands=4, rows_per_band=8, chunk_size=64, initial_capacity=256,
              enable_hamming=True)
    planes = DeviceStore(hamming_storage="planes", **kw)
    packed = DeviceStore(hamming_storage="packed", **kw)
    X = rng.standard_normal((150, 32)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    planes.add_signature_batch(np.arange(150), words)
    packed.add_signature_batch(np.arange(150), words)

    import pytest as _pytest

    mp = _pytest.MonkeyPatch()
    mp.setattr(device_mod, "supports_hamming_grouped", lambda *a: False)
    try:
        qw = h.hash_batch_words_host(rng.standard_normal((5, 32)).astype(np.float32))
        h1, i1 = planes.query_hamming(qw, 7)
        h2, i2 = packed.query_hamming(qw, 7)
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_array_equal(i1, i2)
    finally:
        mp.undo()


def test_packed_hamming_sharded(rng):
    import jax

    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh
    from lshrs_tpu.storage.device import DeviceStore

    h = LSHHasher(num_bands=4, rows_per_band=8, dim=32, seed=7)
    mesh = make_mesh(8)
    kw = dict(num_bands=4, rows_per_band=8, chunk_size=64, initial_capacity=512,
              enable_hamming=True, hamming_storage="packed")
    single = DeviceStore(**kw)
    sharded = ShardedDeviceStore(mesh=mesh, **kw)
    X = rng.standard_normal((400, 32)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    single.add_signature_batch(np.arange(400), words)
    sharded.add_signature_batch(np.arange(400), words)
    qw = h.hash_batch_words_host(rng.standard_normal((9, 32)).astype(np.float32))
    h1, i1 = single.query_hamming(qw, 12)
    h2, i2 = sharded.query_hamming(qw, 12)
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(i1, i2)


def test_packed_hamming_persistence_roundtrip(tmp_path, rng):
    from lshrs_tpu import LSHRS

    lsh = LSHRS(
        dim=24, num_perm=16, num_bands=4, rows_per_band=4,
        backend="device", chunk_size=128, initial_capacity=128,
        enable_hamming=True, hamming_storage="packed",
    )
    X = rng.standard_normal((30, 24)).astype(np.float32)
    lsh.index(list(range(30)), X)
    before = lsh.query_hamming(X[4], top_k=3)
    lsh.save_to_disk(tmp_path / "m")
    back = LSHRS.load_from_disk(tmp_path / "m")
    assert back._storage.hamming_storage == "packed"
    assert back._storage._planes is None
    assert back.query_hamming(X[4], top_k=3) == before
