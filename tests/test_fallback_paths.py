"""Coverage for the non-fast-path engines: wide-band chunked scan, big-B
fori-loop counting, and sharded stores with resident payload."""

from __future__ import annotations

import numpy as np
import pytest

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.device import DeviceStore


def oracle_topk(words, ids, qw, num_bands, k):
    n = words.shape[0]
    eq = (words == qw[None, :]).reshape(n, num_bands, -1).all(-1)
    counts = eq.sum(-1)
    cand = sorted((-int(c), int(i)) for c, i in zip(counts, ids) if c > 0)
    return [(i, -c) for c, i in cand[:k]]


@pytest.mark.parametrize("num_bands,rows", [(128, 4), (80, 2)])
def test_wide_band_configs_use_chunked_fallback(num_bands, rows, rng):
    """num_bands > 64 forces the chunked scan; results stay oracle-exact."""
    dim = 24
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=3)
    store = DeviceStore(
        num_bands=num_bands, rows_per_band=rows, chunk_size=128, initial_capacity=128
    )
    assert not store._use_grouped()

    X = rng.standard_normal((300, dim)).astype(np.float32)
    ids = rng.permutation(9000)[:300]
    words = h.hash_batch_words_host(X)
    store.add_signature_batch(ids, words)

    queries = rng.standard_normal((6, dim)).astype(np.float32)
    qw = h.hash_batch_words_host(queries)
    counts, out_ids = store.query_topk(qw, 15)
    for qi in range(6):
        expected = oracle_topk(words, ids, qw[qi], num_bands, 15)
        got = [(int(i), int(c)) for i, c in zip(out_ids[qi], counts[qi]) if c > 0]
        assert got == expected


def test_grouped_and_chunked_agree(rng):
    """Same store contents through both selection engines -> same answers."""
    from lshrs_tpu.ops.scan import (
        collision_topk,
        collision_topk_grouped,
        compute_chunk_ranks,
        compute_global_tie,
    )
    import jax.numpy as jnp

    B, R, dim, c = 8, 8, 16, 512
    h = LSHHasher(num_bands=B, rows_per_band=R, dim=dim, seed=5)
    X = rng.standard_normal((400, dim)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    ids = np.full(c, -1, np.int32)
    ids[:400] = rng.permutation(8000)[:400]
    sig_t = np.zeros((h.words_per_band * B, c), np.uint32)
    sig_t[:, :400] = words.T

    qw = h.hash_batch_words_host(rng.standard_normal((7, dim)).astype(np.float32))
    ranks = compute_chunk_ranks(jnp.asarray(ids), chunk=128)
    tie = compute_global_tie(jnp.asarray(ids))

    c1, i1 = collision_topk(
        jnp.asarray(sig_t), jnp.asarray(ids), ranks, jnp.asarray(qw),
        num_bands=B, k=20, chunk=128,
    )
    c2, i2 = collision_topk_grouped(
        jnp.asarray(sig_t), jnp.asarray(ids), tie, jnp.asarray(qw),
        num_bands=B, k=20, group=32,
    )
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_sharded_store_with_payload_rerank(rng):
    import jax

    from lshrs_tpu import LSHRS
    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    store = ShardedDeviceStore(
        mesh=mesh, num_bands=4, rows_per_band=8, dim=32,
        store_vectors=True, chunk_size=64, initial_capacity=64,
    )
    lsh = LSHRS(dim=32, num_perm=32, num_bands=4, rows_per_band=8, storage=store)
    X = rng.standard_normal((100, 32)).astype(np.float32)
    lsh.index(list(range(100)), X)

    out = lsh.get_above_p(X[13], p=0.5)
    assert out[0][0] == 13
    assert abs(out[0][1] - 1.0) < 1e-4
    scores = [s for _, s in out]
    assert scores == sorted(scores, reverse=True)


def test_very_wide_bands_w4(rng):
    """r = 128 (W = 4 words per band) through the grouped engine."""
    h = LSHHasher(num_bands=2, rows_per_band=128, dim=24, seed=11)
    store = DeviceStore(
        num_bands=2, rows_per_band=128, chunk_size=128, initial_capacity=128
    )
    X = rng.standard_normal((200, 24)).astype(np.float32)
    ids = rng.permutation(5000)[:200]
    words = h.hash_batch_words_host(X)
    store.add_signature_batch(ids, words)

    qw = h.hash_batch_words_host(rng.standard_normal((5, 24)).astype(np.float32))
    counts, out_ids = store.query_topk(qw, 10)
    for qi in range(5):
        expected = oracle_topk(words, ids, qw[qi], 2, 10)
        got = [(int(i), int(c)) for i, c in zip(out_ids[qi], counts[qi]) if c > 0]
        assert got == expected

    # self-query must match both bands exactly
    counts, out_ids = store.query_topk(words[:1], 1)
    assert out_ids[0][0] == ids[0] and counts[0][0] == 2
