"""Group-max kernels (Triton route): interpret-mode equivalence with the
plain XLA formulation, tiling, padding and the choice of route."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops.pallas_scan import (
    collision_group_max_keys,
    key_scale,
    supports_fast_path,
)
from lshrs_tpu.ops.scan import (
    band_counts_t,
    collision_topk_grouped,
    compute_global_tie,
)


@pytest.mark.parametrize("num_bands,rows", [(4, 8), (8, 16), (2, 40)])
def test_group_max_keys_matches_jnp(num_bands, rows, rng):
    dim, c, q = 16, 1024, 16
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=1)
    X = rng.standard_normal((600, dim)).astype(np.float32)
    words = h.hash_batch_words_host(X)

    sig_t = np.zeros((h.words_per_band * num_bands, c), np.uint32)
    sig_t[:, :600] = words.T
    ids = np.full(c, -1, np.int32)
    ids[:600] = rng.permutation(5000)[:600]
    tie = np.asarray(compute_global_tie(jnp.asarray(ids)))
    qwords = h.hash_batch_words_host(rng.standard_normal((q, dim)).astype(np.float32))

    scale, group = key_scale(c), 64
    kw = dict(num_bands=num_bands, words=h.words_per_band, group=group, scale=scale)
    args = (jnp.asarray(sig_t), jnp.asarray(tie), jnp.asarray(qwords))
    got = np.asarray(collision_group_max_keys(*args, kernel="interpret", **kw))
    want = np.asarray(collision_group_max_keys(*args, **kw))  # XLA
    np.testing.assert_array_equal(got, want)

    counts = np.asarray(band_counts_t(jnp.asarray(sig_t), jnp.asarray(qwords), num_bands))
    # key = count*scale + bias, bias = tie (alive) / -B*scale (dead); group
    # g holds the contiguous slots [g*group, (g+1)*group).
    bias = np.where(tie >= 0, tie, -num_bands * scale)
    key = counts * scale + bias[None, :]
    expected = key.reshape(q, c // group, group).max(axis=2)
    np.testing.assert_array_equal(got, expected)


def test_grouped_topk_pallas_interpret_end_to_end(rng):
    num_bands, rows, dim, c = 4, 8, 16, 512
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=2)
    X = rng.standard_normal((300, dim)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    ids_np = rng.permutation(4000)[:300].astype(np.int32)

    sig_t = np.zeros((h.words_per_band * num_bands, c), np.uint32)
    sig_t[:, :300] = words.T
    ids = np.full(c, -1, np.int32)
    ids[:300] = ids_np
    tie = compute_global_tie(jnp.asarray(ids))
    qwords = h.hash_batch_words_host(rng.standard_normal((5, dim)).astype(np.float32))

    kw = dict(num_bands=num_bands, k=12, group=64)
    c_pl, i_pl = collision_topk_grouped(
        jnp.asarray(sig_t), jnp.asarray(ids), tie, jnp.asarray(qwords),
        kernel="interpret", **kw,
    )
    c_jnp, i_jnp = collision_topk_grouped(
        jnp.asarray(sig_t), jnp.asarray(ids), tie, jnp.asarray(qwords), **kw,
    )
    np.testing.assert_array_equal(np.asarray(c_pl), np.asarray(c_jnp))
    np.testing.assert_array_equal(np.asarray(i_pl), np.asarray(i_jnp))

    # and both agree with the brute-force oracle
    for qi in range(5):
        eq = (words == qwords[qi][None, :]).reshape(300, num_bands, -1).all(-1)
        counts = eq.sum(-1)
        cand = sorted((-int(cc), int(ii)) for cc, ii in zip(counts, ids_np) if cc > 0)
        expected = [(i, -cc) for cc, i in cand[:12]]
        got = [
            (int(i), int(cc))
            for i, cc in zip(np.asarray(i_jnp)[qi], np.asarray(c_jnp)[qi])
            if cc > 0
        ]
        assert got == expected


def test_supports_fast_path_bounds():
    assert supports_fast_path(16, 1 << 17)
    assert supports_fast_path(64, 1 << 24)
    assert not supports_fast_path(512, 1 << 22)
    assert not supports_fast_path(65536, 1 << 17)


def test_hierarchical_group_selection_exact(rng):
    """ng >= 8192 triggers the superchunk selection path; results must be
    bit-identical to the chunked-scan oracle."""
    import jax.numpy as jnp

    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.ops.scan import (
        collision_topk_core,
        collision_topk_grouped_core,
        compute_chunk_ranks,
        compute_global_tie,
    )

    B, R, D = 4, 8, 16
    C, group = 16384, 2  # ng = 8192
    h = LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=11)
    n = 3000
    X = rng.standard_normal((n, D)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    ids = np.full(C, -1, np.int32)
    ids[:n] = rng.permutation(100_000)[:n]
    sig_t = np.zeros((words.shape[1], C), np.uint32)
    sig_t[:, :n] = words.T
    ids_j, sig_j = jnp.asarray(ids), jnp.asarray(sig_t)
    tie = compute_global_tie(ids_j)
    ranks = compute_chunk_ranks(ids_j, chunk=2048)

    qw = h.hash_batch_words_host(rng.standard_normal((9, D)).astype(np.float32))
    c1, i1 = collision_topk_core(
        sig_j, ids_j, ranks, jnp.asarray(qw), num_bands=B, k=12, chunk=2048
    )
    c2, i2 = collision_topk_grouped_core(
        sig_j, ids_j, tie, jnp.asarray(qw),
        num_bands=B, k=12, group=group,
    )
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
