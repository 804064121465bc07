"""Device signature store: exactness vs a brute-force oracle, mutations."""

from __future__ import annotations

import numpy as np
import pytest

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.device import DeviceStore

B, R, D = 4, 8, 32


@pytest.fixture
def hasher() -> LSHHasher:
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def make_store(**kw) -> DeviceStore:
    defaults = dict(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64)
    defaults.update(kw)
    return DeviceStore(**defaults)


def oracle_topk(words, ids, qw, k):
    """Exact (count desc, id asc) via full NumPy comparison."""
    n = words.shape[0]
    eq = (words == qw[None, :]).reshape(n, B, -1).all(-1)
    counts = eq.sum(-1)
    cand = sorted((-int(c), int(i)) for c, i in zip(counts, ids) if c > 0)
    return [(i, -c) for c, i in cand[:k]]


def test_topk_exact_vs_oracle(hasher, rng):
    n = 700  # spans multiple chunks and a growth event
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(100_000)[:n]  # scrambled ids stress tie-breaking
    words = hasher.hash_batch_words_host(X)

    store = make_store()
    # two appends to cover the append-offset path
    store.add_signature_batch(ids[:300], words[:300])
    store.add_signature_batch(ids[300:], words[300:])

    queries = rng.standard_normal((25, D)).astype(np.float32)
    qwords = hasher.hash_batch_words_host(queries)
    counts, out_ids = store.query_topk(qwords, 20)
    for qi in range(queries.shape[0]):
        expected = oracle_topk(words, ids, qwords[qi], 20)
        got = [(int(i), int(c)) for i, c in zip(out_ids[qi], counts[qi]) if c > 0]
        assert got == expected, f"query {qi} mismatch"


def test_count_tie_break_by_id_across_chunks(hasher):
    # Identical vectors (identical signatures) => equal counts; ordering
    # must be ascending id regardless of insertion order or chunk placement.
    vec = np.ones((1, D), np.float32)
    words = hasher.hash_batch_words_host(vec)
    store = make_store()
    scrambled = [500, 3, 250, 77, 1000, 42, 8, 999]
    for i in scrambled:
        store.add_signature_batch([i], words)
    counts, ids = store.query_topk(words, len(scrambled))
    assert list(ids[0]) == sorted(scrambled)
    assert all(c == B for c in counts[0])


def test_upsert_replaces_signature(hasher, rng):
    X = rng.standard_normal((10, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store()
    store.add_signature_batch(np.arange(10), words)

    x_new = rng.standard_normal((1, D)).astype(np.float32)
    w_new = hasher.hash_batch_words_host(x_new)
    store.add_signature_batch([0], w_new)
    assert len(store) == 10  # no duplicate slot

    counts, ids = store.query_topk(w_new, 3)
    assert ids[0][0] == 0 and counts[0][0] == B
    # old signature no longer matches id 0 fully
    counts_old, ids_old = store.query_topk(words[:1], 3)
    full = [int(i) for i, c in zip(ids_old[0], counts_old[0]) if c == B]
    assert 0 not in full


def test_within_batch_duplicates_keep_last(hasher, rng):
    X = rng.standard_normal((3, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store()
    store.add_signature_batch([7, 7, 7], words)
    assert len(store) == 1
    counts, ids = store.query_topk(words[2:3], 2)
    assert ids[0][0] == 7 and counts[0][0] == B


def test_delete_and_clear(hasher, rng):
    X = rng.standard_normal((50, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store()
    store.add_signature_batch(np.arange(50), words)

    store.remove_indices([5, 6, 7])
    assert len(store) == 47
    counts, ids = store.query_topk(words[5:6], 5)
    returned = [int(i) for i, c in zip(ids[0], counts[0]) if c > 0]
    assert 5 not in returned

    store.remove_indices([5])  # double-delete is a no-op
    assert len(store) == 47

    store.clear()
    assert len(store) == 0
    counts, ids = store.query_topk(words[:1], 5)
    assert (counts == 0).all()


def test_growth_preserves_content(hasher, rng):
    store = make_store(chunk_size=64, initial_capacity=64)
    X = rng.standard_normal((1000, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    for start in range(0, 1000, 100):
        store.add_signature_batch(
            np.arange(start, start + 100), words[start : start + 100]
        )
    assert store.stats()["capacity"] >= 1000
    counts, ids = store.query_topk(words[987:988], 1)
    assert ids[0][0] == 987 and counts[0][0] == B


def test_bucket_parity_api(hasher, rng):
    X = rng.standard_normal((20, D)).astype(np.float32)
    store = make_store()
    # Feed per-band bucket ops, deliberately interleaved across vectors.
    ops = []
    for i in range(20):
        sig = hasher.hash_vector(X[i])
        for band_id, band in enumerate(sig):
            ops.append((band_id, band, i))
    ops = ops[::2] + ops[1::2]  # shuffle band arrival order
    store.batch_add(ops)
    assert len(store) == 20

    sig5 = hasher.hash_vector(X[5])
    bucket = store.get_bucket(2, sig5[2])
    assert 5 in bucket

    with pytest.raises(ValueError):
        store.get_bucket(B + 1, sig5[0])


def test_state_arrays_roundtrip(hasher, rng):
    X = rng.standard_normal((30, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store(store_vectors=True, dim=D)
    store.add_signature_batch(np.arange(30), words, X)
    store.remove_indices([3])

    snap = store.state_arrays()
    fresh = make_store(store_vectors=True, dim=D)
    fresh.load_state_arrays(snap)
    assert len(fresh) == 29
    counts, ids = fresh.query_topk(words[10:11], 1)
    assert ids[0][0] == 10
    np.testing.assert_array_equal(fresh.get_vectors([10])[0], X[10])


def test_id_validation(hasher):
    store = make_store()
    w = np.zeros((1, store.words), np.uint32)
    with pytest.raises(ValueError, match="indices"):
        store.add_signature_batch([-1], w)
    with pytest.raises(ValueError, match="indices"):
        store.add_signature_batch([2**31], w)
    with pytest.raises(ValueError, match="shape"):
        store.add_signature_batch([1], np.zeros((1, store.words + 1), np.uint32))


def test_query_counts_full(hasher, rng):
    X = rng.standard_normal((40, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store()
    store.add_signature_batch(np.arange(40), words)
    counts, ids = store.query_counts(words[7:8])
    alive = ids >= 0
    by_id = dict(zip(ids[alive].tolist(), counts[0][alive].tolist()))
    assert by_id[7] == B
    # oracle check of every count
    eq = (words == words[7][None, :]).reshape(40, B, -1).all(-1).sum(-1)
    for i in range(40):
        assert by_id[i] == eq[i]


def test_compact_reclaims_tombstones(hasher, rng):
    X = rng.standard_normal((40, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store(store_vectors=True, dim=D)
    store.add_signature_batch(np.arange(40), words, X)
    store.remove_indices(list(range(10)))
    assert store.stats()["tombstones"] == 10

    assert store.compact() == 10
    assert store.stats()["tombstones"] == 0
    assert len(store) == 30
    # contents intact after compaction
    counts, ids = store.query_topk(words[25:26], 1)
    assert ids[0][0] == 25 and counts[0][0] == B
    np.testing.assert_array_equal(store.get_vectors([25])[0], X[25])
    assert store.compact() == 0  # idempotent


def test_snapshot_query_fn_matches_query_topk(rng):
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    h = LSHHasher(num_bands=4, rows_per_band=8, dim=32, seed=3)
    store = DeviceStore(
        num_bands=4, rows_per_band=8, chunk_size=128, initial_capacity=512,
        enable_hamming=True,
    )
    X = rng.standard_normal((300, 32)).astype(np.float32)
    ids = rng.permutation(10_000)[:300]
    store.add_signature_batch(ids, h.hash_batch_words_host(X))

    Q = rng.standard_normal((17, 32)).astype(np.float32)
    qw = h.hash_batch_words_host(Q)
    dense = h.hash_batch_dense_host(Q)
    _, want = store.query_topk(qw, 7)

    for kwargs, sig in (
        (dict(wire="words"), qw),
        (dict(wire="dense"), dense),
        (dict(wire="dense", dev_batch=8), dense),
    ):
        got = np.asarray(store.snapshot_query_fn(7, **kwargs)(sig))
        np.testing.assert_array_equal(got, want)

    _, want_h = store.query_hamming(qw, 5)
    got_h = np.asarray(
        store.snapshot_query_fn(5, wire="dense", mode="hamming")(dense)
    )
    np.testing.assert_array_equal(got_h, want_h)

    # mutating the store invalidates the snapshot (buffers are donated)
    import pytest

    fn = store.snapshot_query_fn(3, wire="words")
    store.add_signature_batch([99_999], h.hash_batch_words_host(X[:1]))
    with pytest.raises(RuntimeError, match="stale"):
        fn(h.hash_batch_words_host(X[:1]))

    with pytest.raises(ValueError, match="wire"):
        store.snapshot_query_fn(3, wire="morse")
    empty = DeviceStore(num_bands=4, rows_per_band=8, initial_capacity=128)
    with pytest.raises(RuntimeError, match="non-empty"):
        empty.snapshot_query_fn(3)


def test_grouped_refine_table_layouts(rng):
    """Row g of the grouped refine table holds slots [g*group, (g+1)*group)
    word-major — the contiguous groups every group-max formulation (XLA
    and the GPU kernel) produces — and the gather returns them as
    (words, tie, ids) blocks."""
    import jax.numpy as jnp

    from lshrs_tpu.ops.scan import (
        build_grouped_refine_rows,
        gather_refine_group_rows,
    )

    c, nc, group = 512, 6, 8
    bw = nc - 2
    ext = jnp.asarray(
        rng.integers(0, 2**31, (c, nc), dtype=np.int64).astype(np.uint32)
    )

    contig = build_grouped_refine_rows(ext, group=group)
    assert contig.shape == (c // group, nc * group)
    g = 29
    slots = g * group + np.arange(group)
    np.testing.assert_array_equal(
        np.asarray(contig[g]).reshape(nc, group), np.asarray(ext)[slots].T
    )

    # gather returns word-major (words, tie, ids) blocks per group
    tg = jnp.asarray([[g, 0], [1, g]], dtype=jnp.int32)
    words, tie, ids = gather_refine_group_rows(contig, tg, bw=bw, group=group)
    assert words.shape == (2, 2, bw, group)
    np.testing.assert_array_equal(
        np.asarray(words[0, 0]), np.asarray(ext)[slots][:, :bw].T
    )
    np.testing.assert_array_equal(
        np.asarray(tie[1, 1]), np.asarray(ext)[slots][:, bw].astype(np.int32)
    )
    np.testing.assert_array_equal(
        np.asarray(ids[0, 0]),
        np.asarray(ext)[slots][:, bw + 1].astype(np.int32),
    )


def test_grouped_refine_matches_elementwise_fallback(rng):
    """Queries through the grouped refine table are bit-identical to the
    sig_rows=None element-gather fallback."""
    import jax.numpy as jnp

    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.ops.hamming import hamming_topk_core, unpack_bitplanes
    from lshrs_tpu.ops.scan import (
        build_grouped_refine_rows,
        collision_topk_grouped_core,
        compute_global_tie,
    )
    import jax

    h = LSHHasher(num_bands=4, rows_per_band=8, dim=32, seed=3)
    n, cap, group = 400, 512, 8
    X = rng.standard_normal((n, 32)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    qw = jnp.asarray(
        h.hash_batch_words_host(rng.standard_normal((9, 32)).astype(np.float32))
    )
    sig_rows = np.zeros((cap, 4), np.uint32)
    sig_rows[:n] = words
    ids = np.full(cap, -1, np.int32)
    ids[:n] = rng.permutation(10_000)[:n]
    sig_t = jnp.asarray(sig_rows.T.copy())
    ids = jnp.asarray(ids)
    tie = compute_global_tie(ids)
    ext = jnp.concatenate(
        [
            jnp.asarray(sig_rows),
            jax.lax.bitcast_convert_type(tie, jnp.uint32)[:, None],
            jax.lax.bitcast_convert_type(ids, jnp.uint32)[:, None],
        ],
        axis=1,
    )
    rows_g = build_grouped_refine_rows(ext, group=group)

    kw = dict(num_bands=4, k=11, group=group)
    c1, i1 = collision_topk_grouped_core(sig_t, ids, tie, qw, **kw)
    c2, i2 = collision_topk_grouped_core(
        sig_t, ids, tie, qw, sig_rows=rows_g, **kw
    )
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))

    planes = unpack_bitplanes(jnp.asarray(sig_rows), num_bands=4, rows_per_band=8)
    qbits = unpack_bitplanes(qw, num_bands=4, rows_per_band=8)
    hkw = dict(k=7, chunk=64, group=group)
    h1, hi1 = hamming_topk_core(planes, sig_t, ids, tie, qbits, qw, **hkw)
    h2, hi2 = hamming_topk_core(
        planes, sig_t, ids, tie, qbits, qw, sig_rows=rows_g, **hkw
    )
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    np.testing.assert_array_equal(np.asarray(hi1), np.asarray(hi2))


def test_get_vectors_unknown_or_deleted_id_message(hasher, rng):
    X = rng.standard_normal((6, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store(dim=D, store_vectors=True)
    store.add_signature_batch(np.arange(6), words, X)

    with pytest.raises(KeyError, match="unknown or deleted"):
        store.get_vectors([99])
    store.remove_indices([2])
    with pytest.raises(KeyError, match="unknown or deleted"):
        store.get_vectors([2])  # stale caller after delete
    # surviving ids still resolve
    np.testing.assert_array_equal(store.get_vectors([3])[0], X[3])


def test_refine_table_cache_is_bounded(hasher, rng):
    X = rng.standard_normal((64, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    store = make_store()
    store.add_signature_batch(np.arange(64), words)
    # Request more geometries than the cache bound; LRU must evict.
    for g in [8, 16, 32, 4, 8]:
        store._refine_rows(min(g, store._capacity))
        assert len(store._rows_ext) <= store._MAX_REFINE_GEOMETRIES
    # Most recently used geometry is resident.
    assert 8 in store._rows_ext


def test_query_nnz_matches_full_counts(hasher, rng):
    X = rng.standard_normal((300, D)).astype(np.float32)
    X[200:250] = X[:50]  # duplicate signatures inflate candidate sets
    store = make_store()
    store.add_signature_batch(np.arange(300), hasher.hash_batch_words_host(X))

    qw = hasher.hash_batch_words_host(X[:9])
    counts, ids = store.query_counts(qw)
    expected = ((counts > 0) & (ids[None, :] >= 0)).sum(axis=1)
    np.testing.assert_array_equal(store.query_nnz(qw), expected)
    # deletions shrink the probe
    store.remove_indices([0, 200])
    counts2, ids2 = store.query_counts(qw)
    expected2 = ((counts2 > 0) & (ids2[None, :] >= 0)).sum(axis=1)
    np.testing.assert_array_equal(store.query_nnz(qw), expected2)


def test_unbounded_query_uses_bounded_enumeration(hasher, rng, monkeypatch):
    """query(top_k=None) must go through the nnz probe + bounded top-M,
    never the (Q, capacity) host readback."""
    from lshrs_tpu import LSHRS

    X = rng.standard_normal((120, D)).astype(np.float32)
    lsh = LSHRS(dim=D, num_perm=B * R, num_bands=B, rows_per_band=R,
                backend="device", chunk_size=64, initial_capacity=256)
    lsh.index(list(range(120)), X)

    def boom(*a, **k):  # the unbounded readback must not be touched
        raise AssertionError("query_counts called on the bounded path")

    monkeypatch.setattr(lsh._storage, "query_counts", boom)
    out = lsh.query(X[7], top_k=None)
    assert out[0] == 7
    # parity with the brute-force candidate set
    words = hasher.hash_batch_words_host(X)
    qw = hasher.hash_batch_words_host(X[7:8])[0]
    eq = (words == qw[None, :]).reshape(120, B, -1).all(-1)
    counts = eq.sum(-1)
    expected = [i for c, i in sorted((-int(c), int(i))
                for i, c in enumerate(counts) if c > 0)]
    assert out == expected
