"""Hamming-distance ranking over full signatures — the matmul query mode.

Band-collision counting (the reference's only ranking signal) quantises
each band to hit/miss and discards near-miss information. This mode ranks
candidates by the Hamming distance between *entire* ``num_perm``-bit
signatures — the classic SimHash angular estimator
(``theta ~ pi * hamming / num_perm``) — which uses every bit of the hash
budget and maps onto int8 matrix products:

    signatures as +-1 int8 bitplanes:  (C, num_perm)
    dots = qbits @ planes.T            int8 matmuls, dot = P - 2*hamming
    select by (dot desc, id asc)       packed keys + contiguous group-max,
                                       top-k groups, popcount-exact refine

Selection reuses the group-max exactness argument from the scan engine
(`lshrs_tpu.ops.scan`): keys embed each slot's global id-rank so they are
globally distinct, hence the top-k groups by max provably contain every
true top-k slot; the refine stage recomputes those candidates' Hamming
distances from the *packed* words (XOR + popcount — 4x less gather traffic
than re-reading bitplanes).

This is an extension beyond reference parity (`query_hamming` on `LSHRS`):
it typically dominates collision counting for recall at equal memory while
running at matmul throughput instead of elementwise-compare throughput.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lshrs_tpu.ops.pallas_scan import dot_group_max_keys, key_scale
from lshrs_tpu.ops.scan import merge_topk_pools, topk_wide, topk_wide_2key

__all__ = [
    "cascade_coarse_scale",
    "unpack_bitplanes",
    "hamming_topk",
    "hamming_topk_cascade",
    "hamming_topk_cascade_core",
    "hamming_topk_core",
    "hamming_topk_chunked",
    "hamming_topk_chunked_core",
    "hamming_topk_packed",
    "hamming_topk_packed_core",
    "hamming_topk_packed_chunked_core",
    "supports_hamming_grouped",
]


def supports_hamming_grouped(num_perm: int, capacity: int) -> bool:
    """True when the (scaled-dot, tie) key packs into a positive int32."""
    return (num_perm + 2) * key_scale(capacity) < 2**31


def cascade_coarse_scale(p_pre: int, capacity: int) -> tuple[int, int]:
    """``(scale, tie_shift)`` for the cascade's coarse group-max key.

    The coarse key ``scaled * scale + (tie >> tie_shift)`` must pack into
    a positive int32 with ``scaled`` in ``[0, p_pre + 1]``. Below the
    ceiling the shift is 0 and the key is the standard exact-selection
    format; past it the tie term is right-shifted — coarse group
    SELECTION then collapses ties within ``2**tie_shift`` id-rank
    buckets, which only perturbs *which* equal-distance groups enter the
    refine pool (the refine stage re-ranks with the true tie)."""
    scale = key_scale(capacity)
    tie_shift = 0
    while (p_pre + 2) * (scale >> tie_shift) >= 2**31:
        tie_shift += 1
    return scale >> tie_shift, tie_shift


@partial(jax.jit, static_argnames=("num_bands", "rows_per_band"))
def unpack_bitplanes(
    words: jax.Array, *, num_bands: int, rows_per_band: int
) -> jax.Array:
    """Packed uint32 signature words -> +-1 int8 bitplanes.

    Args:
        words: ``(n, num_bands * W)`` uint32 (see `lshrs_tpu.ops.bitpack`).
    Returns:
        ``(n, num_bands * rows_per_band)`` int8 in {-1, +1}, bit order
        matching the packing (band-major, row-minor).
    """
    n = words.shape[0]
    w = words.shape[1] // num_bands
    banded = words.reshape(n, num_bands, w)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (banded[..., None] >> shifts) & jnp.uint32(1)  # (n, B, W, 32)
    bits = bits.reshape(n, num_bands, w * 32)[:, :, :rows_per_band]
    return (2 * bits.astype(jnp.int8) - 1).reshape(n, num_bands * rows_per_band)


def hamming_topk_core(
    planes: jax.Array,
    sig_t: jax.Array,
    ids: jax.Array,
    tie: jax.Array,
    qbits: jax.Array,
    qwords: jax.Array,
    *,
    k: int,
    chunk: int,
    group: int,
    kernel: str | None = None,
    sig_rows: jax.Array | None = None,
    narrow_r: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k by (hamming asc, id asc), grouped matmul path.

    Args:
        planes: ``(C, P)`` int8 store bitplanes (dead slots arbitrary).
        sig_t: ``(BW, C)`` uint32 packed store (for the refine stage).
        ids / tie: slot ids (-1 dead) and global tie keys.
        qbits / qwords: ``(Q, P)`` int8 and ``(Q, BW)`` uint32 queries.
        chunk / group: XLA scan tile and group width (group | chunk | C).
        kernel: group-max route (`lshrs_tpu.ops.pallas_scan.KERNEL_MODES`).
        sig_rows: optional ``(C // group, group * (BW + 2))`` GROUPED
            refine table (`lshrs_tpu.ops.scan.build_grouped_refine_rows`);
            refinement then gathers one wide row per candidate GROUP
            instead of per-slot rows.

    Returns:
        ``(hamming (Q, k), out_ids (Q, k))``; empty tail entries carry
        id -1 and hamming P+1.
    """
    c, p = planes.shape
    gmax = dot_group_max_keys(
        planes, tie, qbits,
        group=group, chunk=chunk, scale=key_scale(c), kernel=kernel,
    )
    return _select_refine(
        gmax, sig_t, ids, tie, qwords,
        p=p, k=k, group=group, sig_rows=sig_rows, narrow_r=narrow_r,
    )


def _select_refine(
    gmax, sig_t, ids, tie, qwords, *, p, k, group, sig_rows, narrow_r=0,
    m_groups=None,
):
    """Shared Hamming selection tail: top-k groups by max (hierarchical),
    popcount-exact refine from packed words, exact (hamming, id) order.

    ``narrow_r`` mirrors `collision_topk_grouped_core`: nonzero means
    ``sig_rows`` is narrow-packed (`lshrs_tpu.ops.bitpack.pack_words_narrow`).
    Popcount is layout-agnostic — the narrow words hold exactly the same
    set bits — so only the word count and the query packing change.

    ``m_groups``: refine the top this-many groups instead of the default
    ``k`` (the refinement-cascade widening: the coarse pass's group maxes
    need a deeper pool to cover full-width top-k — see
    :func:`hamming_topk_cascade_core`). The refine keys promote to int64
    when ``(p + 2) * key_scale(C)`` no longer packs into int32, so the
    cascade stays correct past the grouped engines' 4M-slot key ceiling.
    """
    from lshrs_tpu.ops.scan import _hierarchical_top_groups, _pool_top_groups

    c = ids.shape[0]
    q = qwords.shape[0]
    scale = key_scale(c)
    ng = c // group
    m = min(k if m_groups is None else max(k, m_groups), ng)
    if m_groups is not None:
        # Deep refine pool (the cascade): the pool is heuristic — refine
        # re-ranks it with true keys — so it need not be exact (see
        # _pool_top_groups).
        top_groups = _pool_top_groups(gmax, m=m)
    else:
        top_groups = _hierarchical_top_groups(gmax, m=m)
    # Refine from packed words: hamming = sum popcount(xor) over the words.
    bw = sig_t.shape[0]
    mg = m * group
    if sig_rows is not None:
        from lshrs_tpu.ops.bitpack import narrow_words_count, pack_words_narrow
        from lshrs_tpu.ops.scan import gather_refine_group_rows

        if narrow_r:
            num_bands = bw  # narrow applies only when words-per-band == 1
            nw = narrow_words_count(num_bands, narrow_r)
            qcmp = pack_words_narrow(
                qwords, num_bands=num_bands, rows_per_band=narrow_r
            )
        else:
            nw = bw
            qcmp = qwords
        cwords, cand_tie, cand_ids = gather_refine_group_rows(
            sig_rows, top_groups, bw=nw, group=group
        )
        slots = None
        hamming = None
        for wi in range(nw):
            pc = jax.lax.population_count(
                cwords[:, :, wi, :] ^ qcmp[:, wi][:, None, None]
            )
            hamming = pc.astype(jnp.int32) if hamming is None else hamming + pc
        hamming = hamming.reshape(q, mg)
        cand_tie = cand_tie.reshape(q, mg)
        cand_ids = cand_ids.reshape(q, mg)
    else:
        slots = (
            top_groups[..., None] * group + jnp.arange(group)[None, None, :]
        ).reshape(q, m * group)
        cand_words = jnp.take(sig_t, slots.reshape(-1), axis=1).reshape(bw, q, mg)
        hamming = None
        for wi in range(bw):
            pc = jax.lax.population_count(cand_words[wi] ^ qwords[:, wi][:, None])
            hamming = pc.astype(jnp.int32) if hamming is None else hamming + pc
        cand_tie = jnp.take(tie, slots.reshape(-1)).reshape(q, mg)
        cand_ids = None
    alive = cand_tie >= 0
    scaled = jnp.where(alive, p + 1 - hamming, 0)
    k_eff = min(k, mg)
    if (p + 2) * scale >= 2**31:
        # Past the int32 key ceiling (capacity ~8M+ at num_perm=256) the
        # global tie no longer packs next to the scaled distance, so
        # select lexicographically by (scaled desc, tie desc) — exactly
        # the global (hamming asc, id asc) order — with the two-key
        # blockwise selector. No key packing, no capacity ceiling.
        # (int64 keys would be the obvious fix, but jnp.int64 silently
        # truncates to int32 unless the x64 flag is enabled globally.)
        sel_scaled, _, top_pos = topk_wide_2key(scaled, cand_tie, k_eff)
    else:
        key = scaled * scale + jnp.maximum(cand_tie, 0)
        top_key, top_pos = topk_wide(key, k_eff)
        sel_scaled = top_key // scale
    if cand_ids is not None:
        picked = jnp.take_along_axis(cand_ids, top_pos, axis=1)
    else:
        sel_slots = jnp.take_along_axis(slots, top_pos, axis=1)
        picked = jnp.take(ids, sel_slots.reshape(-1)).reshape(q, k_eff)
    sel_ids = jnp.where(sel_scaled > 0, picked, -1)
    out_h = jnp.where(sel_scaled > 0, p + 1 - sel_scaled, p + 1)
    if k_eff < k:
        out_h = jnp.pad(out_h, ((0, 0), (0, k - k_eff)), constant_values=p + 1)
        sel_ids = jnp.pad(sel_ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return out_h, sel_ids


def hamming_topk_cascade_core(
    planes_prefix: jax.Array,
    sig_t: jax.Array,
    ids: jax.Array,
    tie: jax.Array,
    qbits_prefix: jax.Array,
    qwords: jax.Array,
    *,
    num_perm: int,
    k: int,
    refine_groups: int,
    chunk: int,
    group: int,
    kernel: str | None = None,
    sig_rows: jax.Array | None = None,
    narrow_r: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Two-pass refinement-cascade Hamming top-k (the >=4M-slot engine).

    A full ``num_perm``-bit scan is matmul-bound at large capacity: its
    int8 dot grows as ``Q * C * num_perm``. The cascade scans a PREFIX of
    the bitplanes (pass 1: group-max keys over ``cb =
    planes_prefix.shape[1]`` bits — ``cb/num_perm`` of the matmul work),
    selects the top ``refine_groups`` groups per query, and
    re-ranks every slot in those groups by the FULL ``num_perm``-bit
    popcount from the packed words (pass 2, the existing refine stage).

    Contract: the output is the exact (hamming asc, id asc) top-k *within
    the refined pool* (``refine_groups * group`` slots). Unlike the
    single-pass engines it is NOT provably equal to the full-width
    ranking — the prefix pass can exclude a true top-k slot — so the
    cascade is an explicit opt-in (`DeviceStore(hamming_cascade=...)`).
    Because the prefix is itself a valid SimHash (the first ``cb``
    hyperplanes), a miss requires a slot to rank far worse on ``cb`` bits
    than on ``num_perm`` — unlikely for near neighbours; ``chip_smoke.py``
    checks planted recall at 4M slots.

    The coarse key packs into int32 at ANY capacity: when
    ``(cb + 2) * key_scale(C)`` would overflow, the coarse pass right-
    shifts the tie term (``tie >> s`` with ``scale >> s``) — group
    SELECTION then collapses ties within ``2**s`` id-rank buckets, which
    only perturbs *which* equal-distance groups enter the refine pool;
    the refine stage re-ranks with the TRUE tie, so the reported order
    stays exact-within-pool. This is what re-opens the grouped fast path
    above 4M for any prefix width (e.g. cb=128 at 16M slots).
    """
    c = planes_prefix.shape[0]
    scale, tie_shift = cascade_coarse_scale(planes_prefix.shape[1], c)
    tie_coarse = jnp.where(tie >= 0, tie >> tie_shift, tie) if tie_shift else tie
    gmax = dot_group_max_keys(
        planes_prefix, tie_coarse, qbits_prefix,
        group=group, chunk=chunk, scale=scale, kernel=kernel,
    )
    return _select_refine(
        gmax, sig_t, ids, tie, qwords,
        p=num_perm, k=k, group=group, sig_rows=sig_rows, narrow_r=narrow_r,
        m_groups=refine_groups,
    )


hamming_topk_cascade = partial(
    jax.jit,
    static_argnames=(
        "num_perm", "k", "refine_groups", "chunk", "group", "kernel",
        "narrow_r",
    ),
)(hamming_topk_cascade_core)


def hamming_topk_packed_core(
    sig_t: jax.Array,
    ids: jax.Array,
    tie: jax.Array,
    qwords: jax.Array,
    *,
    num_perm: int,
    k: int,
    chunk: int,
    group: int,
    sig_rows: jax.Array | None = None,
    narrow_r: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Exact Hamming top-k from PACKED words only (no bitplane array).

    Zero memory overhead vs collision mode: distances come from
    XOR + popcount over the same ``(BW, C)`` packed store the collision
    scan uses, vs the bitplane formulation's ``num_perm`` bytes/slot of
    extra device memory. Same results, bit-identical. XLA fuses the
    XOR/popcount/add chain into the group-max reduction; a Triton kernel
    of the same chain measured 2.7x slower end to end on an H100 (PERF.md).
    """
    bw, c = sig_t.shape
    q = qwords.shape[0]
    scale = key_scale(c)
    p = num_perm

    nchunks = c // chunk
    sig_c = jnp.moveaxis(sig_t.reshape(bw, nchunks, chunk), 1, 0)
    tie_c = tie.reshape(nchunks, chunk)

    def body(carry, xs):
        chunk_sig_t, chunk_tie = xs
        ham = None
        for wi in range(bw):
            pc = jax.lax.population_count(
                chunk_sig_t[wi, :][None, :] ^ qwords[:, wi][:, None]
            )
            ham = pc.astype(jnp.int32) if ham is None else ham + pc
        alive = (chunk_tie >= 0).astype(jnp.int32)[None, :]
        scaled = (p + 1 - ham) * alive
        key = scaled * scale + jnp.maximum(chunk_tie, 0)[None, :]
        return carry, key.reshape(q, chunk // group, group).max(axis=-1)

    _, gmax = jax.lax.scan(body, 0, (sig_c, tie_c))
    gmax = jnp.moveaxis(gmax, 0, 1).reshape(q, c // group)

    return _select_refine(
        gmax, sig_t, ids, tie, qwords,
        p=p, k=k, group=group, sig_rows=sig_rows, narrow_r=narrow_r,
    )


def hamming_topk_packed_chunked_core(
    sig_t: jax.Array,
    ids: jax.Array,
    ranks: jax.Array,
    qwords: jax.Array,
    *,
    num_perm: int,
    k: int,
    chunk: int,
) -> tuple[jax.Array, jax.Array]:
    """Packed-words chunked fallback (grouped key does not fit int32)."""
    bw, c = sig_t.shape
    q = qwords.shape[0]
    p = num_perm
    nchunks = c // chunk
    k_chunk = min(k, chunk)

    sig_c = jnp.moveaxis(sig_t.reshape(bw, nchunks, chunk), 1, 0)
    ids_c = ids.reshape(nchunks, chunk)
    ranks_c = ranks.reshape(nchunks, chunk)

    def body(carry, xs):
        chunk_sig_t, chunk_ids, chunk_ranks = xs
        ham = None
        for wi in range(bw):
            pc = jax.lax.population_count(
                chunk_sig_t[wi, :][None, :] ^ qwords[:, wi][:, None]
            )
            ham = pc.astype(jnp.int32) if ham is None else ham + pc
        scaled = jnp.where(chunk_ids[None, :] >= 0, p + 1 - ham, 0)
        key = scaled * chunk + (chunk - 1 - chunk_ranks)[None, :]
        top_key, top_pos = jax.lax.top_k(key, k_chunk)
        sel_scaled = top_key // chunk
        sel_ids = jnp.take_along_axis(
            jnp.broadcast_to(chunk_ids[None, :], (q, chunk)), top_pos, axis=1
        )
        return carry, (sel_scaled, sel_ids)

    _, (pool_scaled, pool_ids) = jax.lax.scan(body, 0, (sig_c, ids_c, ranks_c))
    pool_scaled = jnp.moveaxis(pool_scaled, 0, 1).reshape(q, -1)
    pool_ids = jnp.moveaxis(pool_ids, 0, 1).reshape(q, -1)
    scaled_out, ids_out = merge_topk_pools(pool_scaled, pool_ids, k=k)
    hamming = jnp.where(ids_out >= 0, p + 1 - scaled_out, p + 1)
    return hamming, ids_out


hamming_topk_packed = partial(
    jax.jit,
    static_argnames=(
        "num_perm", "k", "chunk", "group", "narrow_r",
    ),
)(hamming_topk_packed_core)
hamming_topk_packed_chunked = partial(
    jax.jit, static_argnames=("num_perm", "k", "chunk")
)(hamming_topk_packed_chunked_core)


def hamming_topk_chunked_core(
    planes: jax.Array,
    ids: jax.Array,
    ranks: jax.Array,
    qbits: jax.Array,
    *,
    k: int,
    chunk: int,
) -> tuple[jax.Array, jax.Array]:
    """Chunked-selection fallback (very wide num_perm where the grouped
    key cannot pack into int32). Same results, slower selection."""
    c, p = planes.shape
    q = qbits.shape[0]
    nchunks = c // chunk
    k_chunk = min(k, chunk)

    planes_c = planes.reshape(nchunks, chunk, p)
    ids_c = ids.reshape(nchunks, chunk)
    ranks_c = ranks.reshape(nchunks, chunk)

    def body(carry, xs):
        chunk_planes, chunk_ids, chunk_ranks = xs
        dots = jax.lax.dot_general(
            qbits,
            chunk_planes,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        scaled = jnp.where(chunk_ids[None, :] >= 0, (dots + p) // 2 + 1, 0)
        key = scaled * chunk + (chunk - 1 - chunk_ranks)[None, :]
        top_key, top_pos = jax.lax.top_k(key, k_chunk)
        sel_scaled = top_key // chunk
        sel_ids = jnp.take_along_axis(
            jnp.broadcast_to(chunk_ids[None, :], (q, chunk)), top_pos, axis=1
        )
        return carry, (sel_scaled, sel_ids)

    _, (pool_scaled, pool_ids) = jax.lax.scan(body, 0, (planes_c, ids_c, ranks_c))
    pool_scaled = jnp.moveaxis(pool_scaled, 0, 1).reshape(q, -1)
    pool_ids = jnp.moveaxis(pool_ids, 0, 1).reshape(q, -1)
    scaled_out, ids_out = merge_topk_pools(pool_scaled, pool_ids, k=k)
    hamming = jnp.where(ids_out >= 0, p + 1 - scaled_out, p + 1)
    return hamming, ids_out


hamming_topk = partial(
    jax.jit,
    static_argnames=(
        "k", "chunk", "group", "kernel", "narrow_r",
    ),
)(hamming_topk_core)
hamming_topk_chunked = partial(jax.jit, static_argnames=("k", "chunk"))(
    hamming_topk_chunked_core
)
