"""int8 quantized resident payload (`payload_dtype="int8"`).

Per-row symmetric quantization ``rows = round(127 * x / max|x|)`` stores
the payload at a QUARTER of f32 (dim + 8 bytes/slot including norm and
reconstruction scale) — the precision tier for 768-dim payloads next to
a large index. The
quantization scale cancels out of the cosine (``pnorm`` is the integer
rows' norm), so rerank ranks by the cosine of the quantized direction.
"""

from __future__ import annotations

import numpy as np
import pytest

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.device import DeviceStore


def _make_store(dt: str, dim: int = 64, **kw) -> DeviceStore:
    kw.setdefault("initial_capacity", 1024)
    kw.setdefault("chunk_size", 256)
    return DeviceStore(
        num_bands=8,
        rows_per_band=8,
        dim=dim,
        store_vectors=True,
        payload_dtype=dt,
        **kw,
    )


@pytest.fixture
def built(rng):
    dim = 64
    hasher = LSHHasher(num_bands=8, rows_per_band=8, dim=dim, seed=7)
    X = rng.standard_normal((400, dim)).astype(np.float32)
    # Spread row magnitudes over ~30x so per-row scales genuinely differ.
    X *= (0.1 + 3.0 * rng.random(400)).astype(np.float32)[:, None]
    words = np.asarray(hasher.hash_batch_words(X))
    stores = {}
    for dt in ("float32", "int8"):
        s = _make_store(dt, dim)
        s.add_signature_batch(np.arange(400), words, X)
        stores[dt] = s
    return hasher, X, words, stores


def test_validation():
    with pytest.raises(ValueError, match="payload_dtype"):
        _make_store("int4")
    s = _make_store("int8")
    assert s.payload_dtype == "int8"
    assert s._pscale is not None


def test_get_vectors_dequantizes(built):
    _, X, _, stores = built
    got = stores["int8"].get_vectors([0, 7, 399])
    ref = X[[0, 7, 399]]
    # Per-coordinate error bound: half a quantization step of the row max.
    bound = 0.5 / 127.0 * np.abs(ref).max(axis=1, keepdims=True) + 1e-7
    assert (np.abs(got - ref) <= bound).all()


def test_rerank_matches_f32_store(built):
    hasher, X, _, stores = built
    rng = np.random.default_rng(3)
    q = X[:16] + 0.01 * rng.standard_normal((16, X.shape[1])).astype(np.float32)
    qw = np.asarray(hasher.hash_batch_words(q))
    for engine in ("full", "gather"):
        ids8, sims8, n8 = stores["int8"].query_topp_batch(
            qw, q, 10, engine=engine
        )
        ids32, sims32, n32 = stores["float32"].query_topp_batch(
            qw, q, 10, engine=engine
        )
        # Same candidate sets (counts are payload-independent)...
        assert np.array_equal(n8, n32)
        # ...same winners on well-separated data, cosines within the
        # quantization budget (~4e-3 at this dim).
        assert (ids8[:, 0] == ids32[:, 0]).all()
        valid = ids8 >= 0
        assert np.abs(sims8 - sims32)[valid].max() < 2e-2


def test_engines_agree_on_int8(built):
    hasher, X, _, stores = built
    rng = np.random.default_rng(4)
    q = X[32:40] + 0.01 * rng.standard_normal((8, X.shape[1])).astype(
        np.float32
    )
    qw = np.asarray(hasher.hash_batch_words(q))
    ids_f, sims_f, n_f = stores["int8"].query_topp_batch(qw, q, 10, engine="full")
    ids_g, sims_g, n_g = stores["int8"].query_topp_batch(
        qw, q, 10, engine="gather"
    )
    assert np.array_equal(n_f, n_g)
    assert np.array_equal(ids_f, ids_g)
    # Both engines score from the same int8 rows; formulations may differ
    # by bf16 accumulation order only. Padding entries (ids == -1) carry
    # unspecified sims on both paths.
    valid = ids_f >= 0
    assert np.abs(sims_f - sims_g)[valid].max() < 1e-2


def test_checkpoint_roundtrip_preserves_queries(built):
    hasher, X, _, stores = built
    src = stores["int8"]
    state = src.state_arrays()
    dst = _make_store("int8", 64)
    dst.load_state_arrays(state)
    # The stored integer rows restore bit-for-bit (scale recovery never
    # crosses a rounding boundary), so queries are unchanged.
    assert np.array_equal(
        np.asarray(src._payload[:400]), np.asarray(dst._payload[:400])
    )
    rng = np.random.default_rng(5)
    q = X[:8] + 0.01 * rng.standard_normal((8, X.shape[1])).astype(np.float32)
    qw = np.asarray(hasher.hash_batch_words(q))
    a = src.query_topp_batch(qw, q, 10)
    b = dst.query_topp_batch(qw, q, 10)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    # Dequantized exports agree to the 1-ulp scale recovery.
    np.testing.assert_allclose(
        state["payload"], dst.state_arrays()["payload"], rtol=3e-7
    )


def test_upsert_and_delete_maintain_scales(built):
    hasher, X, words, stores = built
    s = stores["int8"]
    rng = np.random.default_rng(6)
    # Overwrite id 5 with a much larger vector (new scale).
    v = 50.0 * rng.standard_normal((1, X.shape[1])).astype(np.float32)
    w = np.asarray(hasher.hash_batch_words(v))
    s.add_signature_batch([5], w, v)
    got = s.get_vectors([5])
    bound = 0.5 / 127.0 * np.abs(v).max() + 1e-6
    assert np.abs(got - v).max() <= bound
    s.remove_indices([5])
    with pytest.raises(KeyError):
        s.get_vectors([5])


def test_memory_accounting(built):
    _, _, _, stores = built
    st8 = stores["int8"].stats()
    st32 = stores["float32"].stats()
    cap, dim = st8["capacity"], 64
    assert st8["payload_bytes"] == cap * dim + cap * 4
    assert st32["payload_bytes"] == cap * dim * 4


def test_grow_preserves_scales(rng):
    dim = 32
    hasher = LSHHasher(num_bands=4, rows_per_band=8, dim=dim, seed=9)
    s = DeviceStore(
        num_bands=4,
        rows_per_band=8,
        dim=dim,
        store_vectors=True,
        payload_dtype="int8",
        initial_capacity=64,
        chunk_size=64,
    )
    X = 10.0 * rng.standard_normal((300, dim)).astype(np.float32)
    words = np.asarray(hasher.hash_batch_words(X))
    for lo in range(0, 300, 50):  # forces capacity growth 64 -> 512
        s.add_signature_batch(
            np.arange(lo, lo + 50), words[lo : lo + 50], X[lo : lo + 50]
        )
    got = s.get_vectors(list(range(300)))
    bound = 0.5 / 127.0 * np.abs(X).max(axis=1, keepdims=True) + 1e-6
    assert (np.abs(got - X) <= bound).all()


def test_fused_device_build_int8(rng):
    """add_vectors_batch (hash + append in one program) quantizes too."""
    dim = 64
    hasher = LSHHasher(num_bands=8, rows_per_band=8, dim=dim, seed=11)
    s = _make_store("int8", dim, dedupe=False)
    X = rng.standard_normal((200, dim)).astype(np.float32)
    s.add_vectors_batch(np.arange(200), X, hasher.device_projection())
    qw = np.asarray(hasher.hash_batch_words(X[:8]))
    ids, sims, n = s.query_topp_batch(qw, X[:8], 5)
    assert (ids[:, 0] == np.arange(8)).all()
    assert (sims[:, 0] > 0.999).all()  # self-cosine vs quantized self


def test_sharded_int8_matches_unsharded(rng):
    """int8 payload on the sharded store: scales shard with the slot axis
    and the rerank matches the single-device result id-for-id."""
    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

    dim = 64
    hasher = LSHHasher(num_bands=8, rows_per_band=8, dim=dim, seed=7)
    X = rng.standard_normal((400, dim)).astype(np.float32)
    X *= (0.1 + 3.0 * rng.random(400)).astype(np.float32)[:, None]
    words = np.asarray(hasher.hash_batch_words(X))
    kw = dict(
        num_bands=8, rows_per_band=8, dim=dim, store_vectors=True,
        payload_dtype="int8", chunk_size=64, initial_capacity=64,
    )
    single = DeviceStore(**kw)
    sharded = ShardedDeviceStore(mesh=make_mesh(8), **kw)
    single.add_signature_batch(np.arange(400), words, X)
    sharded.add_signature_batch(np.arange(400), words, X)
    assert sharded._pscale is not None

    qv = X[:6]
    qw = words[:6]
    i1, s1, n1 = single.query_topp_batch(qw, qv, 9)
    i2, s2, n2 = sharded.query_topp_batch(qw, qv, 9)
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(i1, i2)
    valid = i1 >= 0
    np.testing.assert_allclose(s1[valid], s2[valid], atol=1e-2)
    # reconstruction agrees across placements
    np.testing.assert_array_equal(
        single.get_vectors([3, 77, 399]), sharded.get_vectors([3, 77, 399])
    )


def test_lshrs_int8_end_to_end(make_device_lsh, rng):
    lsh = make_device_lsh(store_vectors=True, payload_dtype="int8")
    X = rng.standard_normal((60, 32)).astype(np.float32)
    lsh.index(list(range(60)), X)
    res = lsh.get_above_p(X[3], 0.5)
    assert res[0][0] == 3
    assert res[0][1] > 0.999
    assert lsh._tpu_config["payload_dtype"] == "int8"


def test_lshrs_int8_persistence(make_device_lsh, rng, tmp_path):
    lsh = make_device_lsh(store_vectors=True, payload_dtype="int8")
    X = rng.standard_normal((40, 32)).astype(np.float32)
    lsh.index(list(range(40)), X)
    before = lsh.get_above_p(X[7], 0.5)
    lsh.save_to_disk(tmp_path / "idx")
    from lshrs_tpu import LSHRS

    re = LSHRS.load_from_disk(tmp_path / "idx")
    assert re._tpu_config["payload_dtype"] == "int8"
    after = re.get_above_p(X[7], 0.5)
    assert [i for i, _ in before] == [i for i, _ in after]
    np.testing.assert_allclose(
        [s for _, s in before], [s for _, s in after], atol=1e-6
    )
