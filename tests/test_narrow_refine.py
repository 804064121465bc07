"""Narrow (dense-packed) refine-table parity.

The refine stage may pack several bands per uint32 word when they divide
32 evenly (`lshrs_tpu.ops.bitpack.pack_words_narrow`) — halving gather
traffic at the flagship r=16. These tests pin (a) the packing layout,
(b) bit-exact equality of the narrow and wide refine paths for the
collision, Hamming, and gather-rerank cores, and (c) eligibility edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops.bitpack import (
    narrow_refine_r,
    narrow_words_count,
    pack_words_narrow,
)
from lshrs_tpu.ops.hamming import hamming_topk_packed_core
from lshrs_tpu.ops.rerank import rerank_topp_gather_core
from lshrs_tpu.ops.scan import (
    build_grouped_refine_rows,
    collision_topk_grouped_core,
    compute_global_tie,
)


def test_eligibility():
    assert narrow_refine_r(16) == 16
    assert narrow_refine_r(8) == 8
    assert narrow_refine_r(4) == 4
    assert narrow_refine_r(32) == 0  # already word-aligned
    assert narrow_refine_r(20) == 0  # does not divide 32
    assert narrow_refine_r(12) == 0


def test_pack_words_narrow_layout():
    r, num_bands = 16, 4
    words = jnp.asarray(
        [[0x0001_AAAA, 0xFFFF_BBBB, 0x1234_CCCC, 0x0000_DDDD]], dtype=jnp.uint32
    )
    packed = np.asarray(
        pack_words_narrow(words, num_bands=num_bands, rows_per_band=r)
    )
    # bands 0,1 -> word 0 (low, high); bands 2,3 -> word 1. High garbage
    # bits above rows_per_band are masked off.
    assert packed.shape == (1, 2)
    assert packed[0, 0] == np.uint32(0xBBBB_AAAA)
    assert packed[0, 1] == np.uint32(0xDDDD_CCCC)


def test_pack_words_narrow_partial_last_word():
    r, num_bands = 8, 5  # bpw=4 -> 2 words, last holds one band
    rng = np.random.default_rng(0)
    words = jnp.asarray(
        rng.integers(0, 256, size=(7, num_bands), dtype=np.uint32)
    )
    packed = np.asarray(
        pack_words_narrow(words, num_bands=num_bands, rows_per_band=r)
    )
    assert packed.shape == (7, narrow_words_count(num_bands, r))
    w = np.asarray(words)
    expect0 = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
    assert np.array_equal(packed[:, 0], expect0.astype(np.uint32))
    assert np.array_equal(packed[:, 1], w[:, 4].astype(np.uint32))


def _build(num_bands, r, c, q, seed=0):
    h = LSHHasher(num_bands=num_bands, rows_per_band=r, dim=32, seed=41)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, 32)).astype(np.float32)
    words = jnp.asarray(h.hash_batch_words_host(x))
    ids = jnp.arange(c, dtype=jnp.int32)
    tie = compute_global_tie(ids)
    qw = words[:q]
    return words, ids, tie, qw, x


def _rows(words, tie, ids, *, group, narrow_r_val, num_bands, r):
    w = words
    if narrow_r_val:
        w = pack_words_narrow(w, num_bands=num_bands, rows_per_band=r)
    ext = jnp.concatenate(
        [
            w,
            jax.lax.bitcast_convert_type(tie, jnp.uint32)[:, None],
            jax.lax.bitcast_convert_type(ids, jnp.uint32)[:, None],
        ],
        axis=1,
    )
    return build_grouped_refine_rows(ext, group=group)


@pytest.mark.parametrize("num_bands,r", [(16, 16), (8, 8), (5, 8)])
def test_collision_grouped_narrow_matches_wide(num_bands, r):
    c, q, k, group = 512, 64, 7, 8
    words, ids, tie, qw, _ = _build(num_bands, r, c, q)
    common = dict(
        num_bands=num_bands, k=k, group=group,
    )
    wide = collision_topk_grouped_core(
        words.T, ids, tie, qw,
        sig_rows=_rows(words, tie, ids, group=group, narrow_r_val=0,
                       num_bands=num_bands, r=r),
        **common,
    )
    nar = collision_topk_grouped_core(
        words.T, ids, tie, qw,
        sig_rows=_rows(words, tie, ids, group=group, narrow_r_val=r,
                       num_bands=num_bands, r=r),
        narrow_r=r,
        **common,
    )
    assert np.array_equal(np.asarray(wide[0]), np.asarray(nar[0]))
    assert np.array_equal(np.asarray(wide[1]), np.asarray(nar[1]))


def test_hamming_packed_narrow_matches_wide():
    num_bands, r = 16, 16
    c, q, k, group = 512, 32, 9, 8
    words, ids, tie, qw, _ = _build(num_bands, r, c, q)
    common = dict(
        num_perm=num_bands * r, k=k, chunk=256, group=group,
    )
    wide = hamming_topk_packed_core(
        words.T, ids, tie, qw,
        sig_rows=_rows(words, tie, ids, group=group, narrow_r_val=0,
                       num_bands=num_bands, r=r),
        **common,
    )
    nar = hamming_topk_packed_core(
        words.T, ids, tie, qw,
        sig_rows=_rows(words, tie, ids, group=group, narrow_r_val=r,
                       num_bands=num_bands, r=r),
        narrow_r=r,
        **common,
    )
    assert np.array_equal(np.asarray(wide[0]), np.asarray(nar[0]))
    assert np.array_equal(np.asarray(wide[1]), np.asarray(nar[1]))


def test_rerank_gather_narrow_matches_wide():
    num_bands, r = 16, 16
    c, q, group = 512, 16, 8
    words, ids, tie, qw, x = _build(num_bands, r, c, q)
    payload = jnp.asarray(x)
    pnorm = jnp.linalg.norm(payload, axis=1)
    qv = payload[:q]
    common = dict(
        num_bands=num_bands, max_out=5, max_candidates=16, group=group,
    )
    wide = rerank_topp_gather_core(
        payload, pnorm, ids, tie, words.T, qw, qv,
        sig_rows=_rows(words, tie, ids, group=group, narrow_r_val=0,
                       num_bands=num_bands, r=r),
        **common,
    )
    nar = rerank_topp_gather_core(
        payload, pnorm, ids, tie, words.T, qw, qv,
        sig_rows=_rows(words, tie, ids, group=group, narrow_r_val=r,
                       num_bands=num_bands, r=r),
        narrow_r=r,
        **common,
    )
    for a, b in zip(wide, nar):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_device_store_uses_narrow_when_eligible():
    from lshrs_tpu.storage.device import DeviceStore

    s16 = DeviceStore(num_bands=4, rows_per_band=16, dim=16)
    assert s16._refine_narrow_r == 16
    s32 = DeviceStore(num_bands=4, rows_per_band=32, dim=16)
    assert s32._refine_narrow_r == 0

    # Narrow store still answers exact queries (refine path engages when
    # the grouped fast path does; tiny stores may fall back — the contract
    # here is correctness either way).
    h = LSHHasher(num_bands=4, rows_per_band=16, dim=16, seed=3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    w = h.hash_batch_words_host(x)
    s16.add_signature_batch(np.arange(300), w)
    counts, out = s16.query_topk(w[:32], 3)
    assert np.array_equal(out[:, 0], np.arange(32))
