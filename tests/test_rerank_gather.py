"""Candidate-gather rerank engine: exactness vs the full-matmul path,
coverage/truncation detection, engine resolution, persistence."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from lshrs_tpu import LSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops.rerank import rerank_topp_gather_core
from lshrs_tpu.storage.device import DeviceStore

B, R, D = 4, 8, 32


@pytest.fixture
def hasher() -> LSHHasher:
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def make_store(**kw) -> DeviceStore:
    defaults = dict(
        num_bands=B, rows_per_band=R, dim=D, store_vectors=True,
        chunk_size=256, initial_capacity=4096, group_size=64,
    )
    defaults.update(kw)
    return DeviceStore(**defaults)


@pytest.fixture
def populated(hasher, rng):
    n = 2000
    X = rng.standard_normal((n, D)).astype(np.float32)
    # clusters of near-duplicates so candidate sets are non-trivial
    X[1000:1100] = X[:100] + 0.01 * rng.standard_normal((100, D)).astype(np.float32)
    store = make_store()
    store.add_signature_batch(np.arange(n), hasher.hash_batch_words_host(X), X)
    return store, X


def test_gather_matches_full_when_covered(populated, hasher, rng):
    store, X = populated
    Q = np.concatenate([X[:6], rng.standard_normal((4, D)).astype(np.float32)])
    qw = hasher.hash_batch_words_host(Q)

    full_ids, full_sims, full_n = store.query_topp_batch(qw, Q, 64, engine="full")
    g_ids, g_sims, g_n = store.query_topp_batch(
        qw, Q, 64, engine="gather", max_candidates=1024
    )
    np.testing.assert_array_equal(g_n, full_n)
    np.testing.assert_array_equal(g_ids, full_ids)
    valid = full_ids >= 0  # entries past n carry unspecified sims
    np.testing.assert_allclose(
        g_sims[valid], full_sims[valid], rtol=1e-5, atol=1e-6
    )
    assert store.stats()["rerank_truncations"] == 0


def test_gather_truncation_detected_and_counted(hasher, rng):
    # every vector identical -> every slot collides with the query
    n = 512
    X = np.tile(rng.standard_normal((1, D)).astype(np.float32), (n, 1))
    store = make_store(initial_capacity=512, dedupe=False)
    store.add_signature_batch(np.arange(n), hasher.hash_batch_words_host(X), X)

    qw = hasher.hash_batch_words_host(X[:1])
    ids, sims, cnt = store.query_topp_batch(
        qw, X[:1], 64, engine="gather", max_candidates=64
    )
    assert store.stats()["rerank_truncations"] == 1
    # truncated ranking holds the 64 most-colliding candidates: counts are
    # all equal here, so the (count, tie) selection keeps the lowest ids,
    # and equal cosines order by id.
    assert list(ids[0]) == list(range(64))
    assert int(cnt[0]) >= 64  # lower bound on the true candidate count


def test_gather_core_exact_flag(populated, hasher, rng):
    store, X = populated
    store._ensure_ranks()
    qw = jnp.asarray(hasher.hash_batch_words_host(X[:4]), dtype=jnp.uint32)
    _, _, n, exact = rerank_topp_gather_core(
        store._payload, store._pnorm, store._ids, store._tie, store._sig_t,
        qw, jnp.asarray(X[:4]),
        num_bands=B, max_out=16, max_candidates=512,
        group=64,
    )
    assert bool(np.asarray(exact).all())
    # a tiny budget on a self-query with near-dup cluster -> not exact
    _, _, _, exact_small = rerank_topp_gather_core(
        store._payload, store._pnorm, store._ids, store._tie, store._sig_t,
        qw, jnp.asarray(X[:4]),
        num_bands=B, max_out=4, max_candidates=1,
        group=64,
    )
    assert not bool(np.asarray(exact_small).all())


def test_gather_pallas_interpret_parity(populated, hasher):
    """The GPU collision kernel (interpret mode) with the grouped refine
    table must agree bit-for-bit with the plain XLA formulation."""
    store, X = populated
    store._ensure_ranks()
    qw = jnp.asarray(hasher.hash_batch_words_host(X[:8]), dtype=jnp.uint32)
    kw = dict(num_bands=B, max_out=32, max_candidates=256, group=64)
    ids_x, sims_x, n_x, ex_x = rerank_topp_gather_core(
        store._payload, store._pnorm, store._ids, store._tie, store._sig_t,
        qw, jnp.asarray(X[:8]), **kw,
    )
    ids_p, sims_p, n_p, ex_p = rerank_topp_gather_core(
        store._payload, store._pnorm, store._ids, store._tie, store._sig_t,
        qw, jnp.asarray(X[:8]), kernel="interpret",
        sig_rows=store._refine_rows(64),
        narrow_r=store._refine_narrow_r, **kw,
    )
    ids_x, ids_p = np.asarray(ids_x), np.asarray(ids_p)
    np.testing.assert_array_equal(ids_p, ids_x)
    np.testing.assert_array_equal(np.asarray(n_p), np.asarray(n_x))
    np.testing.assert_array_equal(np.asarray(ex_p), np.asarray(ex_x))
    valid = ids_x >= 0  # entries past the valid prefix carry junk sims
    np.testing.assert_allclose(
        np.asarray(sims_p)[valid], np.asarray(sims_x)[valid], rtol=1e-6
    )


def test_snapshot_topp_fn_gather_matches_and_staleness(populated, hasher):
    store, X = populated
    qw = hasher.hash_batch_words_host(X[:5])
    ref = store.query_topp_batch(qw, X[:5], 32, engine="gather", max_candidates=512)

    serve = store.snapshot_topp_fn(32, engine="gather", max_candidates=512)
    got = tuple(np.asarray(x) for x in serve(qw, X[:5]))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], ref[2])

    store.add_signature_batch([9999], hasher.hash_batch_words_host(X[:1]), X[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qw, X[:5])


def test_engine_resolution(populated):
    store, X = populated
    # auto on a small store -> full (capacity below the threshold)
    assert store._resolve_rerank_engine(None, None)[0] == "full"
    # past the capacity floor AND the measured cost crossover -> gather
    store._GATHER_MIN_CAPACITY = 1024
    store._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 2
    assert store._resolve_rerank_engine("auto", 1024)[0] == "gather"
    # below the crossover the full matmul is cheaper
    store._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 10_000
    assert store._resolve_rerank_engine("auto", 1024)[0] == "full"
    store._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 2
    # expected candidate load exceeding the budget keeps the full engine
    assert store._resolve_rerank_engine("auto", 4)[0] == "full"
    with pytest.raises(ValueError, match="engine"):
        store._resolve_rerank_engine("approximate", None)
    with pytest.raises(ValueError, match="max_candidates"):
        store._resolve_rerank_engine("full", 0)
    # explicit gather without payload/fast-path support is refused
    bare = DeviceStore(num_bands=B, rows_per_band=R, chunk_size=128,
                       initial_capacity=128)
    with pytest.raises(RuntimeError, match="gather"):
        bare._resolve_rerank_engine("gather", 64)


def test_rerank_config_persistence_roundtrip(rng):
    import pickle

    X = rng.standard_normal((40, 16)).astype(np.float32)
    lsh = LSHRS(
        dim=16, num_perm=16, num_bands=4, rows_per_band=4,
        backend="device", store_vectors=True,
        chunk_size=128, initial_capacity=128,
        rerank_engine="full", rerank_candidates=333,
    )
    lsh.index(list(range(40)), X)
    re = pickle.loads(pickle.dumps(lsh))
    assert re._tpu_config["rerank_engine"] == "full"
    assert re._tpu_config["rerank_candidates"] == 333
    assert re._storage.rerank_engine == "full"
    assert re._storage.rerank_candidates == 333
    with pytest.raises(ValueError, match="rerank_engine"):
        LSHRS(dim=16, num_perm=16, backend="device", rerank_engine="nope")


def test_sharded_gather_matches_unsharded_full(rng):
    """The shard_map gather rerank (per-shard gather + cosine ICI merge)
    must match the single-device full formulation id-for-id on covered
    queries, and serve through the sharded snapshot closure."""
    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

    n = 600
    X = rng.standard_normal((n, D)).astype(np.float32)
    X[300:360] = X[:60] + 0.01 * rng.standard_normal((60, D)).astype(np.float32)
    h = LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)
    words = h.hash_batch_words_host(X)

    single = make_store(initial_capacity=1024, chunk_size=128)
    single.add_signature_batch(np.arange(n), words, X)
    sharded = ShardedDeviceStore(
        mesh=make_mesh(8), num_bands=B, rows_per_band=R, dim=D,
        store_vectors=True, chunk_size=128, initial_capacity=1024,
        group_size=64,
    )
    sharded.add_signature_batch(np.arange(n), words, X)

    qv = X[:6]
    qw = h.hash_batch_words_host(qv)
    ref_ids, ref_sims, ref_n = single.query_topp_batch(qw, qv, 16, engine="full")
    g_ids, g_sims, g_n = sharded.query_topp_batch(
        qw, qv, 16, engine="gather", max_candidates=256
    )
    np.testing.assert_array_equal(g_ids, ref_ids)
    np.testing.assert_array_equal(g_n, ref_n)
    valid = ref_ids >= 0
    np.testing.assert_allclose(g_sims[valid], ref_sims[valid], rtol=1e-5)
    assert sharded.stats()["rerank_truncations"] == 0

    serve = sharded.snapshot_topp_fn(16, engine="gather", max_candidates=256)
    s_ids, s_sims, s_n = (np.asarray(x) for x in serve(qw, qv))
    np.testing.assert_array_equal(s_ids, ref_ids)
    np.testing.assert_array_equal(s_n, ref_n)
    sharded.add_signature_batch([5000], words[:1], X[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qw, qv)


def test_gather_multiword_bands(rng):
    """rows_per_band > 32 (two uint32 words per band) exercises the
    multi-word compare loops in the gather refine stage."""
    b2, r2, d2 = 2, 40, 24  # w = ceil(40/32) = 2 words/band
    h2 = LSHHasher(num_bands=b2, rows_per_band=r2, dim=d2, seed=7)
    store = DeviceStore(
        num_bands=b2, rows_per_band=r2, dim=d2, store_vectors=True,
        chunk_size=64, initial_capacity=256, group_size=16,
    )
    X = rng.standard_normal((150, d2)).astype(np.float32)
    X[100:120] = X[:20]  # exact duplicates force collisions
    store.add_signature_batch(np.arange(150), h2.hash_batch_words_host(X), X)

    qw = h2.hash_batch_words_host(X[:5])
    f = store.query_topp_batch(qw, X[:5], 12, engine="full")
    g = store.query_topp_batch(qw, X[:5], 12, engine="gather", max_candidates=64)
    np.testing.assert_array_equal(g[0], f[0])
    np.testing.assert_array_equal(g[2], f[2])


def test_auto_prefers_gather_when_full_cannot_fit(populated):
    """When the full engine's (Q, C) temporaries would exceed the device
    memory budget, auto must take gather even if the expected candidate
    load would truncate."""
    store, X = populated
    store._full_rerank_temp_budget = lambda: 1  # everything is "too big"
    assert store._resolve_rerank_engine("auto", 4)[0] == "gather"
    # without gather support, full remains the only (doomed) option
    bare = DeviceStore(num_bands=B, rows_per_band=R, chunk_size=128,
                       initial_capacity=128)
    bare._full_rerank_temp_budget = lambda: 1
    assert bare._resolve_rerank_engine("auto", 4)[0] == "full"
