"""Sharded store: exact agreement with the single-device oracle on a mesh.

Runs on 8 virtual CPU devices (see conftest XLA flags) — the same
`jax.sharding` / `shard_map` code paths run on the GPUs of one host
(`chip_smoke.py --four-cards` checks them on four cards).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from lshrs_tpu import LSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh
from lshrs_tpu.storage.device import DeviceStore

B, R, D = 4, 8, 32


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def test_mesh_has_eight_devices(mesh):
    assert mesh.devices.size == 8


def test_sharded_matches_unsharded_exactly(mesh, hasher, rng):
    n = 600
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(50_000)[:n]
    words = hasher.hash_batch_words_host(X)

    single = DeviceStore(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64)
    sharded = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64
    )
    single.add_signature_batch(ids, words)
    sharded.add_signature_batch(ids, words)

    queries = rng.standard_normal((10, D)).astype(np.float32)
    qw = hasher.hash_batch_words_host(queries)
    c1, i1 = single.query_topk(qw, 25)
    c2, i2 = sharded.query_topk(qw, 25)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(i1, i2)


def test_sharded_counts_match(mesh, hasher, rng):
    X = rng.standard_normal((200, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    sharded = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64
    )
    sharded.add_signature_batch(np.arange(200), words)
    counts, ids = sharded.query_counts(words[3:4])
    alive = ids >= 0
    by_id = dict(zip(ids[alive].tolist(), counts[0][alive].tolist()))
    eq = (words == words[3][None, :]).reshape(200, B, -1).all(-1).sum(-1)
    for i in range(200):
        assert by_id[i] == eq[i]


def test_sharded_mutations(mesh, hasher, rng):
    X = rng.standard_normal((100, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    st = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64
    )
    st.add_signature_batch(np.arange(100), words)
    st.remove_indices([5])
    assert len(st) == 99
    counts, out = st.query_topk(words[5:6], 3)
    assert 5 not in out[0]
    st.clear()
    assert len(st) == 0

    # growth across the shard-aligned capacity boundary
    st.add_signature_batch(np.arange(100), words)
    X2 = rng.standard_normal((1000, D)).astype(np.float32)
    st.add_signature_batch(np.arange(1000, 2000), hasher.hash_batch_words_host(X2))
    assert st.stats()["capacity"] % (8 * 64) == 0
    counts, out = st.query_topk(words[7:8], 1)
    assert out[0][0] == 7


def test_orchestrator_over_sharded_store(mesh, rng):
    store = ShardedDeviceStore(
        mesh=mesh, num_bands=4, rows_per_band=4, chunk_size=64, initial_capacity=64
    )
    lsh = LSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, storage=store)
    X = rng.standard_normal((120, D)).astype(np.float32)
    lsh.index(list(range(120)), X)
    assert lsh.get_top_k(X[11], topk=3)[0] == 11

    ref = LSHRS(
        dim=D, num_perm=16, num_bands=4, rows_per_band=4,
        backend="device", chunk_size=64, initial_capacity=64,
    )
    ref.index(list(range(120)), X)
    q = rng.standard_normal(D).astype(np.float32)
    assert lsh.query(q, top_k=None) == ref.query(q, top_k=None)


def test_orchestrator_shards_param(rng):
    lsh = LSHRS(
        dim=D, num_perm=16, num_bands=4, rows_per_band=4,
        backend="device", shards=8, chunk_size=64, initial_capacity=64,
    )
    assert lsh.stats()["index"]["n_shards"] == 8
    X = rng.standard_normal((80, D)).astype(np.float32)
    lsh.index(list(range(80)), X)
    assert lsh.get_top_k(X[5], topk=1) == [5]


def test_sharded_save_load_roundtrip(tmp_path, rng):
    lsh = LSHRS(
        dim=D, num_perm=16, num_bands=4, rows_per_band=4,
        backend="device", shards=8, chunk_size=64, initial_capacity=64,
    )
    X = rng.standard_normal((50, D)).astype(np.float32)
    lsh.index(list(range(50)), X)
    lsh.save_to_disk(tmp_path / "m")
    # restores sharded when enough devices exist (8 virtual CPU devices here)
    back = LSHRS.load_from_disk(tmp_path / "m")
    assert back.stats()["index"]["n_shards"] == 8
    q = rng.standard_normal(D).astype(np.float32)
    assert lsh.query(q, top_k=None) == back.query(q, top_k=None)


def test_sharded_save_load_downgrades_when_devices_scarce(tmp_path, rng, monkeypatch):
    lsh = LSHRS(
        dim=D, num_perm=16, num_bands=4, rows_per_band=4,
        backend="device", shards=8, chunk_size=64, initial_capacity=64,
    )
    X = rng.standard_normal((50, D)).astype(np.float32)
    lsh.index(list(range(50)), X)
    lsh.save_to_disk(tmp_path / "m")

    only_one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: only_one)
    back = LSHRS.load_from_disk(tmp_path / "m")
    # documented downgrade: single-device store, identical query results
    assert "n_shards" not in back.stats()["index"]
    q = rng.standard_normal(D).astype(np.float32)
    assert lsh.query(q, top_k=None) == back.query(q, top_k=None)


def test_sharded_append_keeps_placement_without_reshard(mesh, hasher, rng, monkeypatch):
    """Appends must not re-place capacity-wide arrays: GSPMD propagates the
    shardings through the donated update jits (VERDICT round 1, item 10)."""
    st = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=1024,
    )
    calls = {"n": 0}
    orig = ShardedDeviceStore._reshard

    def counting_reshard(self):
        calls["n"] += 1
        return orig(self)

    monkeypatch.setattr(ShardedDeviceStore, "_reshard", counting_reshard)
    X = rng.standard_normal((40, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    for j in range(0, 40, 8):
        st.add_signature_batch(np.arange(j, j + 8), words[j : j + 8])
    assert calls["n"] == 0  # no full re-placement on the append path
    assert st._sig_t.sharding == st._col_sharding
    assert st._ids.sharding == st._row_sharding
    counts, out = st.query_topk(words[3:4], 1)
    assert out[0][0] == 3


def test_sharded_snapshot_query_fn_cross_shard_ties(mesh, hasher, rng):
    """The serving closure must route through the shard_map query: shard-
    local tie keys are only distinct within a shard, so the single-device
    program would misorder equal-count candidates across shards."""
    st = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=1024, enable_hamming=True,
    )
    rows_per_shard = 1024 // 8
    X = rng.standard_normal((1, D)).astype(np.float32)
    w = hasher.hash_batch_words_host(X)
    # same signature under two ids placed on DIFFERENT shards: fill exactly
    # up to one slot before the shard boundary, so id 163 lands at the last
    # slot of shard 0 and id 63 at the first slot of shard 1 — and the
    # shard-local tie of 163 (alone near its shard's tail) exceeds that of
    # 63, which is what the single-device program would mis-order.
    filler = rng.standard_normal((rows_per_shard - 1, D)).astype(np.float32)
    st.add_signature_batch(
        np.arange(1000, 1000 + rows_per_shard - 1),
        hasher.hash_batch_words_host(filler),
    )
    st.add_signature_batch([163], w)
    st.add_signature_batch([63], w)
    assert st._slot_of[163] // rows_per_shard != st._slot_of[63] // rows_per_shard

    _, want = st.query_topk(w, 2)
    got = np.asarray(st.snapshot_query_fn(2, wire="words")(w))
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [63, 163]  # (count desc, id asc) across shards

    # top-1 must be the globally smallest tied id
    got1 = np.asarray(st.snapshot_query_fn(1, wire="words")(w))
    assert got1[0][0] == 63

    # dense wire + hamming mode run through the same sharded path
    dense = hasher.hash_batch_dense_host(X)
    got_d = np.asarray(st.snapshot_query_fn(2, wire="dense")(dense))
    np.testing.assert_array_equal(got_d, want)
    got_h = np.asarray(
        st.snapshot_query_fn(2, wire="dense", mode="hamming")(dense)
    )
    assert got_h[0].tolist() == [63, 163]

    # staleness guard applies to the sharded closure too
    fn = st.snapshot_query_fn(1, wire="words")
    st.add_signature_batch([7], hasher.hash_batch_words_host(
        rng.standard_normal((1, D)).astype(np.float32)))
    with pytest.raises(RuntimeError, match="stale"):
        fn(w)


def test_bucket_index_invalidated_on_upsert(hasher, rng):
    """Upserting an existing id must invalidate the sorted bucket index."""
    st = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=256,
        query_mode="bucket",
    )
    X = rng.standard_normal((20, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    st.add_signature_batch(np.arange(20), words)
    _ = st.query_topk(words[:1], 1)  # builds the bucket index
    # upsert id 0 with a brand-new signature
    x_new = rng.standard_normal((1, D)).astype(np.float32)
    w_new = hasher.hash_batch_words_host(x_new)
    st.add_signature_batch([0], w_new)
    counts, out = st.query_topk(w_new, 1)
    assert out[0][0] == 0 and counts[0][0] == B


def test_sharded_topp_rerank_matches_unsharded(mesh, hasher, rng):
    """The fused top-p rerank on a sharded store (inherited path — GSPMD
    partitions the counts scan and cosine matmul) must match the
    single-device result id-for-id."""
    n = 400
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = np.arange(n)
    words = hasher.hash_batch_words_host(X)

    kw = dict(
        num_bands=B, rows_per_band=R, dim=D, store_vectors=True,
        chunk_size=64, initial_capacity=64,
    )
    single = DeviceStore(**kw)
    sharded = ShardedDeviceStore(mesh=mesh, **kw)
    single.add_signature_batch(ids, words, X)
    sharded.add_signature_batch(ids, words, X)

    qv = X[:6]
    qw = hasher.hash_batch_words_host(qv)
    i1, s1, n1 = single.query_topp_batch(qw, qv, 9)
    i2, s2, n2 = sharded.query_topp_batch(qw, qv, 9)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-5)
    np.testing.assert_array_equal(n1, n2)
    assert (i1[:, 0] == np.arange(6)).all()  # self-match first


def test_sharded_nnz_matches_unsharded(mesh, hasher, rng):
    X = rng.standard_normal((300, D)).astype(np.float32)
    X[150:200] = X[:50]  # shared signatures across shard boundaries
    words = hasher.hash_batch_words_host(X)
    single = DeviceStore(num_bands=B, rows_per_band=R, chunk_size=64,
                         initial_capacity=64)
    sharded = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=64,
        initial_capacity=64,
    )
    single.add_signature_batch(np.arange(300), words)
    sharded.add_signature_batch(np.arange(300), words)
    qw = hasher.hash_batch_words_host(X[:7])
    np.testing.assert_array_equal(sharded.query_nnz(qw), single.query_nnz(qw))


def test_sharded_hamming_pallas_interpret_parity(mesh, hasher, rng):
    """The GPU Hamming kernel under shard_map (interpret mode on the
    virtual mesh) must match the single-device oracle bit-for-bit, and so
    must the packed-words storage (plain XLA on every platform)."""
    from lshrs_tpu.parallel.sharded import (
        _sharded_hamming,
        _sharded_hamming_packed,
    )
    from lshrs_tpu.ops.hamming import unpack_bitplanes

    n = 900
    X = rng.standard_normal((n, D)).astype(np.float32)
    X[400:450] = X[:50]  # exact ties across shards stress the merge
    words = hasher.hash_batch_words_host(X)
    ids = rng.permutation(50_000)[:n]

    # capacity 8192 over 8 shards -> 1024 rows/shard
    single = DeviceStore(
        num_bands=B, rows_per_band=R, chunk_size=1024,
        initial_capacity=8192, group_size=8,
        enable_hamming=True, hamming_storage="planes",
    )
    sharded = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, chunk_size=1024,
        initial_capacity=8192, group_size=8,
        enable_hamming=True, hamming_storage="planes",
    )
    single.add_signature_batch(ids, words)
    sharded.add_signature_batch(ids, words)

    qw = hasher.hash_batch_words_host(X[:10])
    ref_h, ref_i = single.query_hamming(qw, 15)

    sharded._ensure_ranks()
    sharded._ensure_planes()  # bitplanes are lazy; the direct call needs them
    local = sharded._local_rows()
    assert local == 1024
    tile, group = 1024, 8
    rows = sharded._refine_rows(group)
    import jax.numpy as jnp

    qwj = jnp.asarray(qw, dtype=jnp.uint32)
    h_p, i_p = _sharded_hamming_packed(
        sharded.mesh, sharded.axis, sharded._sig_t, rows, sharded._ids,
        sharded._ranks, sharded._tie, qwj,
        num_perm=B * R, k=15, chunk=tile, grouped=True, group=group,
        narrow_r=sharded._refine_narrow_r,
    )
    np.testing.assert_array_equal(np.asarray(i_p), ref_i)
    np.testing.assert_array_equal(np.asarray(h_p), ref_h)

    qbits = unpack_bitplanes(qwj, num_bands=B, rows_per_band=R)
    h_b, i_b = _sharded_hamming(
        sharded.mesh, sharded.axis, sharded._planes, sharded._sig_t, rows,
        sharded._ids, sharded._ranks, sharded._tie, qbits, qwj,
        num_perm=B * R, k=15, chunk=tile, grouped=True, group=group,
        kernel="interpret",
        narrow_r=sharded._refine_narrow_r,
    )
    np.testing.assert_array_equal(np.asarray(i_b), ref_i)
    np.testing.assert_array_equal(np.asarray(h_b), ref_h)


def test_sharded_snapshot_topp_fn_parity_and_staleness(mesh, hasher, rng):
    """The inherited rerank closure on a sharded store (GSPMD partitions
    the counts scan + cosine matmul) must match query_topp_batch exactly,
    serve both wires, and go stale on mutation."""
    n = 300
    X = rng.standard_normal((n, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    st = ShardedDeviceStore(
        mesh=mesh, num_bands=B, rows_per_band=R, dim=D, store_vectors=True,
        chunk_size=64, initial_capacity=64,
    )
    st.add_signature_batch(np.arange(n), words, X)

    qv = X[:5]
    qw = hasher.hash_batch_words_host(qv)
    ref_ids, ref_sims, ref_n = st.query_topp_batch(qw, qv, 7)

    serve = st.snapshot_topp_fn(7, wire="words")
    ids, sims, cnt = (np.asarray(x) for x in serve(qw, qv))
    np.testing.assert_array_equal(ids, ref_ids)
    valid = ref_ids >= 0
    np.testing.assert_allclose(sims[valid], ref_sims[valid], rtol=1e-5)
    np.testing.assert_array_equal(cnt, ref_n)
    assert (ids[:, 0] == np.arange(5)).all()

    dense = hasher.hash_batch_dense_host(qv)
    serve_d = st.snapshot_topp_fn(7, wire="dense")
    ids_d, _, _ = (np.asarray(x) for x in serve_d(dense, qv))
    np.testing.assert_array_equal(ids_d, ref_ids)

    st.add_signature_batch([999], words[:1], X[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qw, qv)
