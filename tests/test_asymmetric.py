"""Asymmetric SimHash ranking: oracle exactness, parity, recall dominance.

The asymmetric estimator keeps the query's quantised projection
coordinates and ranks against the store's sign bitplanes
(`lshrs_tpu.ops.asymmetric`). At capacities where the packed selection
key needs no right-shift (`asymmetric_shift` == 0, i.e. every store
below ~32k slots at num_perm=256 — wider here with the tiny test
num_perm), ordering is EXACT w.r.t. (dots desc, id asc); those cases
are pinned against a NumPy brute-force oracle. Larger capacities add a
documented selection granularity of 2**shift int-dot units, covered by
a statistical test.
"""

from __future__ import annotations

import numpy as np
import pytest

from lshrs_tpu import LSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops.asymmetric import (
    QMAX,
    asymmetric_shift,
    quantize_coords_jax,
    quantize_coords_np,
)
from lshrs_tpu.storage.device import DeviceStore

B, R, D = 4, 8, 32
P = B * R


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def planes_of(words, hasher):
    """±1 bitplanes in the packing's bit order (band-major, row-minor)."""
    n = words.shape[0]
    out = np.zeros((n, P), np.int8)
    for j in range(P):
        band, row = j // R, j % R
        word, bit = row // 32, row % 32
        out[:, j] = (
            ((words[:, band * hasher.words_per_band + word] >> bit) & 1)
            .astype(np.int8) * 2 - 1
        )
    return out


def oracle_topk(q_i8, store_planes, ids, k):
    """(dots desc, id asc) brute force over alive slots."""
    dots = store_planes.astype(np.int32) @ q_i8.astype(np.int32)
    order = sorted(zip((-dots).tolist(), ids.tolist()))[:k]
    return [(-d, i) for d, i in order]


def test_quantize_coords_contract(rng):
    coords = rng.standard_normal((16, P)).astype(np.float32) * 3.7
    qi8, sumabs = quantize_coords_np(coords)
    assert qi8.dtype == np.int8
    assert np.abs(qi8.astype(np.int32)).max() == QMAX  # row max hits full range
    assert (sumabs == np.abs(qi8.astype(np.int32)).sum(axis=1)).all()
    # JAX twin agrees bit-for-bit (same rint rounding)
    qj, sj = quantize_coords_jax(coords)
    np.testing.assert_array_equal(np.asarray(qj), qi8)
    np.testing.assert_array_equal(np.asarray(sj), sumabs)
    # zero rows quantise to zeros rather than dividing by zero
    z, sz = quantize_coords_np(np.zeros((2, P), np.float32))
    assert (z == 0).all() and (sz == 0).all()


def test_asymmetric_shift_bounds():
    # tiny stores need no shift; the key always fits after shifting
    assert asymmetric_shift(P, 1024) == 0
    for p, cap in [(256, 1 << 17), (256, 1 << 20), (1024, 1 << 22)]:
        s = asymmetric_shift(p, cap)
        from lshrs_tpu.ops.pallas_scan import key_scale

        assert (((2 * p * QMAX) >> s) + 2) * key_scale(cap) < 2**31


def test_asymmetric_matches_oracle(hasher, rng):
    store = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    n = 500
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(30_000)[:n]
    words = hasher.hash_batch_words_host(X)
    store.add_signature_batch(ids, words)
    assert asymmetric_shift(P, store.stats()["capacity"]) == 0  # exact regime

    queries = rng.standard_normal((10, D)).astype(np.float32)
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(queries))
    dots, out_ids = store.query_asymmetric(qi8, 15)

    xb = planes_of(words, hasher)
    for qi in range(10):
        expected = oracle_topk(qi8[qi], xb, ids, 15)
        got = list(zip(dots[qi].tolist(), out_ids[qi].tolist()))
        assert got == expected, f"query {qi}"


def test_asymmetric_after_mutations(hasher, rng):
    store = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    X = rng.standard_normal((300, D)).astype(np.float32)
    ids = np.arange(300)
    words = hasher.hash_batch_words_host(X)
    store.add_signature_batch(ids, words)
    store.remove_indices(list(range(0, 300, 3)))

    queries = rng.standard_normal((5, D)).astype(np.float32)
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(queries))
    dots, out_ids = store.query_asymmetric(qi8, 9)

    alive = np.array([i for i in range(300) if i % 3 != 0])
    xb = planes_of(words[alive], hasher)
    for qi in range(5):
        expected = oracle_topk(qi8[qi], xb, alive, 9)
        got = list(zip(dots[qi].tolist(), out_ids[qi].tolist()))
        assert got == expected, f"query {qi}"


def test_asymmetric_pallas_interpret_matches_xla(hasher, rng):
    """GPU group-max kernel (interpret) == XLA scan path in the exact regime."""
    import jax.numpy as jnp

    from lshrs_tpu.ops.asymmetric import asymmetric_topk
    from lshrs_tpu.ops.hamming import unpack_bitplanes
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
    qi8, _ = quantize_coords_np(
        hasher.hash_batch_coords_host(
            rng.standard_normal((6, D)).astype(np.float32)
        )
    )
    assert asymmetric_shift(P, c) == 0
    kw = dict(k=12, chunk=128, group=32, shift=0)
    d1, i1 = asymmetric_topk(
        planes, jnp.asarray(ids), tie, jnp.asarray(qi8), **kw
    )
    d2, i2 = asymmetric_topk(
        planes, jnp.asarray(ids), tie, jnp.asarray(qi8), kernel="interpret", **kw,
    )
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_asymmetric_chunked_matches_grouped(hasher, rng):
    """The chunked fallback returns the identical exact ordering."""
    import jax.numpy as jnp

    from lshrs_tpu.ops.asymmetric import asymmetric_topk, asymmetric_topk_chunked
    from lshrs_tpu.ops.hamming import unpack_bitplanes
    from lshrs_tpu.ops.scan import compute_chunk_ranks, compute_global_tie

    c = 512
    X = rng.standard_normal((400, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    ids = np.full(c, -1, np.int32)
    ids[:400] = np.arange(400)
    sig_t = np.zeros((hasher.words_per_band * B, c), np.uint32)
    sig_t[:, :400] = words.T
    tie = compute_global_tie(jnp.asarray(ids))
    ranks = compute_chunk_ranks(jnp.asarray(ids), chunk=128)
    planes = unpack_bitplanes(
        jnp.asarray(sig_t.T.copy()), num_bands=B, rows_per_band=R
    )
    qi8, _ = quantize_coords_np(
        hasher.hash_batch_coords_host(
            rng.standard_normal((4, D)).astype(np.float32)
        )
    )
    d1, i1 = asymmetric_topk(
        planes, jnp.asarray(ids), tie, jnp.asarray(qi8),
        k=10, chunk=128, group=32, shift=0,
    )
    d2, i2 = asymmetric_topk_chunked(
        planes, jnp.asarray(ids), ranks, jnp.asarray(qi8), k=10, chunk=128
    )
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_orchestrator_query_asymmetric(rng):
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R,
        enable_hamming=True, initial_capacity=256,
    )
    X = rng.standard_normal((200, D)).astype(np.float32)
    lsh.index(np.arange(200), X)

    res = lsh.query_asymmetric(X[7], top_k=5)
    assert res[0][0] == 7
    assert res[0][1] == pytest.approx(1.0)  # self-query: dots == sum|q|
    assert all(res[i][1] >= res[i + 1][1] or res[i][1] == pytest.approx(
        res[i + 1][1]) for i in range(len(res) - 1))

    batch = lsh.query_asymmetric_batch(X[:4], top_k=3)
    assert [row[0][0] for row in batch] == [0, 1, 2, 3]

    with pytest.raises(ValueError, match="top_k"):
        lsh.query_asymmetric(X[0], top_k=0)
    with pytest.raises(ValueError, match="shape"):
        lsh.query_asymmetric_batch(X[:, :8], top_k=3)


def test_query_asymmetric_requires_hamming(rng):
    # engine="auto" (the default) auto-enables the Hamming capability, so
    # asymmetric ranking works out of the box; only an explicit
    # collision-parity construction lacks the bitplanes.
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R, engine="collision"
    )
    lsh.index(np.arange(10), rng.standard_normal((10, D)).astype(np.float32))
    with pytest.raises(RuntimeError, match="enable_hamming"):
        lsh.query_asymmetric(np.ones(D, np.float32))


def test_query_asymmetric_requires_planes(rng):
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R,
        enable_hamming=True, hamming_storage="packed",
    )
    lsh.index(np.arange(10), rng.standard_normal((10, D)).astype(np.float32))
    with pytest.raises(RuntimeError, match="planes"):
        lsh.query_asymmetric(np.ones(D, np.float32))


def test_query_asymmetric_empty_store():
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R, enable_hamming=True
    )
    assert lsh.query_asymmetric(np.ones(D, np.float32)) == []


def test_sharded_asymmetric_matches_oracle(hasher, rng):
    """8-shard asymmetric ranking == brute-force oracle (exact regime)."""
    import jax

    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    st = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    n = 200
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(9999)[:n]
    words = hasher.hash_batch_words_host(X)
    st.add_signature_batch(ids, words)
    # shard-local capacity is small enough for the exact (shift=0) regime
    assert asymmetric_shift(P, st.stats()["capacity"] // 8) == 0

    queries = rng.standard_normal((3, D)).astype(np.float32)
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(queries))
    dots, out = st.query_asymmetric(qi8, 5)

    xb = planes_of(words, hasher)
    for qi in range(3):
        expected = oracle_topk(qi8[qi], xb, ids, 5)
        got = list(zip(dots[qi].tolist(), out[qi].tolist()))
        assert got == expected, f"query {qi}"


def test_snapshot_asymmetric_matches_query(hasher, rng):
    """snapshot_query_fn(mode='asymmetric') == query_asymmetric ids."""
    store = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    X = rng.standard_normal((300, D)).astype(np.float32)
    ids = np.arange(300)
    words = hasher.hash_batch_words_host(X)
    store.add_signature_batch(ids, words)

    queries = rng.standard_normal((7, D)).astype(np.float32)
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(queries))
    _, want = store.query_asymmetric(qi8, 6)

    serve = store.snapshot_query_fn(6, mode="asymmetric")
    np.testing.assert_array_equal(np.asarray(serve(qi8)), want)

    # mutations invalidate the snapshot
    store.remove_indices([3])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qi8)

    with pytest.raises(ValueError, match="asymmetric"):
        store.snapshot_query_fn(6, mode="cosine")


def test_snapshot_asymmetric_requires_planes(hasher, rng):
    store = DeviceStore(
        num_bands=B, rows_per_band=R, enable_hamming=True,
        hamming_storage="packed",
    )
    words = hasher.hash_batch_words_host(
        rng.standard_normal((20, D)).astype(np.float32)
    )
    store.add_signature_batch(np.arange(20), words)
    with pytest.raises(RuntimeError, match="planes"):
        store.snapshot_query_fn(5, mode="asymmetric")


def test_serving_fn_asymmetric(rng):
    """LSHRS.serving_fn(mode='asymmetric') == query_asymmetric_batch ids."""
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R,
        enable_hamming=True, initial_capacity=256,
    )
    X = rng.standard_normal((220, D)).astype(np.float32)
    lsh.index(np.arange(220), X)

    serve = lsh.serving_fn(top_k=5, mode="asymmetric")
    got = serve(X[:16])
    assert got.shape == (16, 5)
    assert got[:, 0].tolist() == list(range(16))  # self-match first

    want = lsh.query_asymmetric_batch(X[:16], top_k=5)
    for qi in range(16):
        assert got[qi].tolist() == [i for i, _ in want[qi]], f"query {qi}"

    served_before = lsh.stats()["counters"]["queries_served"]
    lsh.index([500], rng.standard_normal((1, D)).astype(np.float32))
    with pytest.raises(RuntimeError, match="stale"):
        serve(X[:2])
    assert lsh.stats()["counters"]["queries_served"] == served_before


def test_sharded_snapshot_asymmetric_matches_single(hasher, rng):
    """8-shard asymmetric serving closure == single-device ids."""
    import jax

    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

    assert len(jax.devices()) >= 8
    st = ShardedDeviceStore(
        mesh=make_mesh(8), num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    single = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    n = 200
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(9999)[:n]
    words = hasher.hash_batch_words_host(X)
    st.add_signature_batch(ids, words)
    single.add_signature_batch(ids, words)
    # both stores sit in the exact (shift=0) selection regime
    assert asymmetric_shift(P, single.stats()["capacity"]) == 0

    queries = rng.standard_normal((5, D)).astype(np.float32)
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(queries))
    serve = st.snapshot_query_fn(7, mode="asymmetric")
    got = np.asarray(serve(qi8))
    want = np.asarray(single.snapshot_query_fn(7, mode="asymmetric")(qi8))
    np.testing.assert_array_equal(got, want)

    st.remove_indices([int(ids[0])])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qi8)


def test_asymmetric_recall_dominates_symmetric(rng):
    """Keeping query coordinates beats sign-sign Hamming on recall@10.

    Clustered data, exact-cosine ground truth; num_perm=64 bits at dim=32.
    Seeded and deterministic. The asymmetric estimator's variance is
    strictly lower (it integrates out the query-side quantisation), so
    its recall should dominate at any fixed bit budget.
    """
    b, r, d = 4, 16, 32
    centers = rng.standard_normal((40, d)).astype(np.float32) * 2.0
    base = np.concatenate(
        [c + rng.standard_normal((50, d)).astype(np.float32) for c in centers]
    )
    n = len(base)
    queries = base[rng.permutation(n)[:64]] + 0.3 * rng.standard_normal(
        (64, d)
    ).astype(np.float32)

    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ bn.T), axis=1)[:, :10]

    lsh = LSHRS(
        dim=d, num_perm=b * r, num_bands=b, rows_per_band=r,
        enable_hamming=True, initial_capacity=2048,
    )
    lsh.index(np.arange(n), base)

    ham = lsh.query_hamming_batch(queries, top_k=10)
    asym = lsh.query_asymmetric_batch(queries, top_k=10)

    def recall(rows):
        hits = sum(
            len({i for i, _ in row} & set(gt[qi].tolist()))
            for qi, row in enumerate(rows)
        )
        return hits / gt.size

    r_ham, r_asym = recall(ham), recall(asym)
    assert r_asym > r_ham, (r_asym, r_ham)


# ---------------------------------------------------------------------------
# int4-packed coordinate wire
# ---------------------------------------------------------------------------


def test_pack_unpack_coords_int4_roundtrip(rng):
    from lshrs_tpu.ops.asymmetric import (
        QMAX4,
        pack_coords_int4_np,
        unpack_coords_int4,
    )

    qi8 = rng.integers(-QMAX4, QMAX4 + 1, size=(17, P)).astype(np.int8)
    packed = pack_coords_int4_np(qi8)
    assert packed.shape == (17, P // 2) and packed.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(unpack_coords_int4(packed)), qi8)

    with pytest.raises(ValueError, match="int4"):
        pack_coords_int4_np(np.full((2, P), 100, np.int8))
    with pytest.raises(ValueError, match="even"):
        pack_coords_int4_np(np.zeros((2, P - 1), np.int8))


def test_snapshot_coords4_matches_int4_quantised_query(hasher, rng):
    """coords4 closure == query path fed the same int4-quantised coords."""
    from lshrs_tpu.ops.asymmetric import QMAX4, pack_coords_int4_np

    store = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    X = rng.standard_normal((280, D)).astype(np.float32)
    store.add_signature_batch(
        np.arange(280), hasher.hash_batch_words_host(X)
    )
    queries = rng.standard_normal((6, D)).astype(np.float32)
    qi4, _ = quantize_coords_np(
        hasher.hash_batch_coords_host(queries), qmax=QMAX4
    )
    _, want = store.query_asymmetric(qi4, 7)

    serve = store.snapshot_query_fn(7, mode="asymmetric", wire="coords4")
    got = np.asarray(serve(pack_coords_int4_np(qi4)))
    np.testing.assert_array_equal(got, want)

    with pytest.raises(ValueError, match="coords4"):
        store.snapshot_query_fn(7, mode="collision", wire="coords4")


def test_sharded_snapshot_coords4_matches_single(hasher, rng):
    import jax

    from lshrs_tpu.ops.asymmetric import QMAX4, pack_coords_int4_np
    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

    assert len(jax.devices()) >= 8
    st = ShardedDeviceStore(
        mesh=make_mesh(8), num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    single = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    n = 180
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(4000)[:n]
    words = hasher.hash_batch_words_host(X)
    st.add_signature_batch(ids, words)
    single.add_signature_batch(ids, words)

    queries = rng.standard_normal((4, D)).astype(np.float32)
    qi4, _ = quantize_coords_np(
        hasher.hash_batch_coords_host(queries), qmax=QMAX4
    )
    wire = pack_coords_int4_np(qi4)
    got = np.asarray(st.snapshot_query_fn(6, mode="asymmetric", wire="coords4")(wire))
    want = np.asarray(
        single.snapshot_query_fn(6, mode="asymmetric", wire="coords4")(wire)
    )
    np.testing.assert_array_equal(got, want)


def test_serving_fn_asymmetric_int4_wire(rng):
    """coords_wire='int4' serves sane results (self-match + recall order)."""
    lsh = LSHRS(
        dim=D, num_perm=P, num_bands=B, rows_per_band=R,
        enable_hamming=True, initial_capacity=256,
    )
    X = rng.standard_normal((240, D)).astype(np.float32)
    lsh.index(np.arange(240), X)
    serve = lsh.serving_fn(top_k=5, mode="asymmetric", coords_wire="int4")
    got = serve(X[:16])
    assert got.shape == (16, 5)
    assert got[:, 0].tolist() == list(range(16))  # self-match first
    with pytest.raises(ValueError, match="coords_wire"):
        lsh.serving_fn(top_k=5, mode="asymmetric", coords_wire="int2")


def test_word_row_refine_multiword_bands(rng):
    """Word-row refine reconstructs exact dots with r=40 (2 words/band)."""
    B2, R2, D2 = 2, 40, 48
    P2 = B2 * R2
    h = LSHHasher(num_bands=B2, rows_per_band=R2, dim=D2, seed=5)
    store = DeviceStore(
        num_bands=B2, rows_per_band=R2, chunk_size=64,
        initial_capacity=64, enable_hamming=True,
    )
    n = 200
    X = rng.standard_normal((n, D2)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    store.add_signature_batch(np.arange(n), words)

    queries = rng.standard_normal((4, D2)).astype(np.float32)
    qi8, _ = quantize_coords_np(h.hash_batch_coords_host(queries))
    dots, ids = store.query_asymmetric(qi8, 6)

    # brute-force oracle over +-1 bitplanes unpacked from the words
    planes = np.zeros((n, P2), np.int8)
    for j in range(P2):
        band, row = j // R2, j % R2
        wi, bit = band * h.words_per_band + row // 32, row % 32
        planes[:, j] = ((words[:, wi] >> bit) & 1).astype(np.int8) * 2 - 1
    for qi in range(4):
        d = planes.astype(np.int32) @ qi8[qi].astype(np.int32)
        order = sorted(zip((-d).tolist(), range(n)))[:6]
        exp = [(-dd, i) for dd, i in order]
        got = [
            (int(dv), int(i)) for dv, i in zip(dots[qi], ids[qi]) if i >= 0
        ]
        assert got == exp, f"query {qi}"
