"""Asymmetric SimHash ranking — float query against the binary store.

Symmetric Hamming ranking (`lshrs_tpu.ops.hamming`) quantises BOTH sides
of the SimHash estimator to sign bits. Only the *store* side must be
quantised — that is the index; the query is in hand at full precision.
Ranking by

    s(q, x) = sum_j  c_j(q) * sign(p_j . x)        c_j(q) = p_j . q

keeps the query's projection coordinates and strictly dominates the
sign-sign estimator's correlation with cosine at identical store memory
(it is the one-bit-store case of asymmetric distance computation — the
same idea PQ/ADC systems use; for Gaussian hyperplanes
``E[c_j sign(p_j.x)] = sqrt(2/pi) ||q|| cos(theta)``, so the
self-normalising estimate ``s / sum_j |c_j|`` converges to
``cos(theta)`` without any distribution constants).

Device formulation — the same int8 group-max scan as symmetric Hamming:

- quantise the query coordinates per-row to int8 (``round(c * 127 /
  max|c_row|)``) — store bitplanes are already int8 ±1, so the scan's
  dot is the identical ``(Q, P) @ (P, CH)`` int8 matmul;
- selection keys pack ``((dots + offset) >> shift) * scale + tie`` with
  ``offset = P * qmax`` and ``shift`` adapted by :func:`asymmetric_shift`
  so the key fits a positive int32 (the group-max machinery's format).
  Selection is provably exact w.r.t. the SHIFTED score ordering (the
  packed keys stay globally distinct through the tie term);
- the selected candidate pool (``k`` groups) is re-ranked by the EXACT
  ``(dots desc, id asc)`` order from freshly gathered bitplane rows, so
  reported scores are exact and monotone. The only approximation beyond
  the estimator itself is selection granularity: a true top-k slot can be
  displaced only by a slot whose shifted key ties it, i.e. by a score
  gap below ``2**shift`` of the int-dot scale (at 1M slots: 32 of
  ±32512 — ~0.1% of the score range).

The reference has no ranking mode at all beyond band-collision counting
(`/root/reference/lshrs/core/main.py:1088-1109`); this module extends the
Hamming extension — same memory, strictly better rank correlation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lshrs_tpu.ops.pallas_scan import dot_group_max_keys, key_scale
from lshrs_tpu.ops.scan import _hierarchical_top_groups, merge_topk_pools

__all__ = [
    "QMAX",
    "QMAX4",
    "asymmetric_shift",
    "quantize_coords_np",
    "quantize_coords_jax",
    "pack_coords_int4_np",
    "unpack_coords_int4",
    "asymmetric_topk",
    "asymmetric_topk_core",
    "asymmetric_topk_chunked",
    "asymmetric_topk_chunked_core",
    "refine_dots_from_words",
]

QMAX = 127  # int8 full range for the quantised query coordinates
QMAX4 = 7  # int4 range for the packed half-byte wire (`pack_coords_int4_np`)


def asymmetric_shift(num_perm: int, capacity: int, qmax: int = QMAX) -> int:
    """Smallest right-shift packing the asymmetric key into int32.

    Requires ``((2 * num_perm * qmax) >> shift + 2) * key_scale(capacity)
    < 2**31`` (the group-max int32 key format). shift=0 whenever capacity
    is small; grows by one per capacity doubling past the packing limit.
    """
    scale = key_scale(capacity)
    budget = (2**31) // scale - 2
    if budget <= 0:
        raise ValueError(f"capacity {capacity} exceeds int32 key packing")
    shift = 0
    while (2 * num_perm * qmax) >> shift > budget:
        shift += 1
    return shift


def quantize_coords_np(
    coords: np.ndarray, qmax: int = QMAX
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row int8 quantisation of query projection coordinates.

    Returns ``(q_i8 (n, P) int8, sum_abs (n,) int32)``; the
    self-normalising cosine estimate of a dot ``d`` against ±1 store
    bitplanes is ``d / sum_abs``. Zero rows (impossible for validated
    queries — zero vectors are rejected upstream) quantise to zeros.
    """
    c = np.asarray(coords, dtype=np.float32)
    m = np.max(np.abs(c), axis=1, keepdims=True)
    s = np.divide(qmax, m, out=np.zeros_like(m), where=m > 0)
    qi8 = np.rint(c * s).astype(np.int8)
    sumabs = np.abs(qi8.astype(np.int32)).sum(axis=1)
    return qi8, sumabs


def pack_coords_int4_np(qi8: np.ndarray) -> np.ndarray:
    """Pack int4-range coords two-per-byte: ``(n, P)`` int8 -> ``(n, P/2)``
    uint8 (low nibble = even column, high nibble = odd column).

    The half-size asymmetric query wire: quantise with ``qmax=QMAX4``,
    pack, ship, and `unpack_coords_int4` restores the coords on device.
    Measured recall cost of 4-bit vs 8-bit query quantisation: ~0.38 vs
    ~0.39 recall@10 at 60k clustered where symmetric Hamming sits at
    ~0.35 — most of the asymmetric gain at half the transport.
    """
    q = np.asarray(qi8, dtype=np.int8)
    if q.ndim != 2 or q.shape[1] % 2:
        raise ValueError("coords must be (n, P) with even P")
    if np.abs(q.astype(np.int32)).max(initial=0) > QMAX4:
        raise ValueError(
            f"int4 packing requires coords in [-{QMAX4}, {QMAX4}]; "
            f"quantise with qmax={QMAX4}"
        )
    u = q.view(np.uint8) & 0xF
    return (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)


def unpack_coords_int4(wire: jax.Array) -> jax.Array:
    """Device twin of :func:`pack_coords_int4_np`: ``(n, P/2)`` uint8 ->
    ``(n, P)`` int8 coords in ``[-QMAX4, QMAX4]`` (sign-extended)."""
    u = wire.astype(jnp.uint8)
    lo = (u & 0xF).astype(jnp.int8)
    hi = (u >> 4).astype(jnp.int8)
    # sign-extend the 4-bit two's-complement nibbles
    lo = ((lo ^ 8) - 8).astype(jnp.int8)
    hi = ((hi ^ 8) - 8).astype(jnp.int8)
    n = u.shape[0]
    return jnp.stack([lo, hi], axis=-1).reshape(n, -1)


def quantize_coords_jax(coords, qmax: int = QMAX):
    """JAX twin of :func:`quantize_coords_np` (same rounding: rint)."""
    c = jnp.asarray(coords, dtype=jnp.float32)
    m = jnp.max(jnp.abs(c), axis=1, keepdims=True)
    s = jnp.where(m > 0, qmax / m, 0.0)
    qi8 = jnp.rint(c * s).astype(jnp.int8)
    sumabs = jnp.abs(qi8.astype(jnp.int32)).sum(axis=1)
    return qi8, sumabs


def _exact_pool_order(dots, cand_ids, alive, k: int, offset: int):
    """Exact (dots desc, id asc) order of a candidate pool.

    The pool's dots range ±offset exceeds the int32 lexicographic packing
    at large capacities, so sort with two explicit keys instead; the pool
    is only ``k * group`` wide, the sort is trivial.
    """
    intmax = jnp.iinfo(jnp.int32).max
    neg = jnp.where(alive, -dots, intmax)
    sids = jnp.where(alive, cand_ids, intmax)
    neg_s, ids_s, dots_s = jax.lax.sort((neg, sids, dots), num_keys=2)
    q = dots.shape[0]
    k_eff = min(k, dots.shape[1])
    valid = ids_s[:, :k_eff] != intmax
    out_ids = jnp.where(valid, ids_s[:, :k_eff], -1)
    out_dots = jnp.where(valid, dots_s[:, :k_eff], -(offset + 1))
    if k_eff < k:
        out_ids = jnp.pad(out_ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        out_dots = jnp.pad(
            out_dots, ((0, 0), (0, k - k_eff)), constant_values=-(offset + 1)
        )
    return out_dots, out_ids


def refine_dots_from_words(
    cwords: jax.Array,
    qcoords: jax.Array,
    *,
    num_bands: int,
    rows_per_band: int,
    narrow_r: int = 0,
) -> jax.Array:
    """Exact asymmetric dots of gathered candidate WORD rows vs query coords.

    ``dots = sum_j c_j * (2 b_j - 1) = 2 * sum_j c_j b_j - sum_j c_j``, so
    the exact int dot reconstructs from the packed signature bits with one
    select-accumulate per coordinate — all fused elementwise work on the
    already-gathered ``(Q, m, nw, group)`` block. This keeps the refine
    stage on the 4-byte-per-word grouped refine table instead of gathering
    full ``num_perm``-byte bitplane rows (3.5x the bytes in 64x the rows).

    Args:
        cwords: ``(Q, m, nw, group)`` uint32 gathered signature words —
            word-aligned when ``narrow_r == 0``, else narrow-packed
            (``32 // narrow_r`` bands per word).
        qcoords: ``(Q, P)`` int8 quantised query coordinates.

    Returns:
        ``(Q, m, group)`` int32 exact dots (as if against ±1 bitplanes).
    """
    c32 = qcoords.astype(jnp.int32)
    csum = c32.sum(axis=1)  # (Q,)
    r = rows_per_band
    nw = cwords.shape[2]
    acc = None
    for b in range(num_bands):
        if narrow_r:
            bpw = 32 // narrow_r
            wi_base, sh_base = b // bpw, (b % bpw) * narrow_r
        else:
            wpb = nw // num_bands
            wi_base, sh_base = b * wpb, 0
        for ri in range(r):
            if narrow_r:
                wi, sh = wi_base, sh_base + ri
            else:
                wi, sh = wi_base + ri // 32, ri % 32
            bit = (
                (cwords[:, :, wi, :] >> jnp.uint32(sh)) & jnp.uint32(1)
            ).astype(jnp.int32)
            term = bit * c32[:, b * r + ri][:, None, None]
            acc = term if acc is None else acc + term
    return 2 * acc - csum[:, None, None]


def asymmetric_topk_core(
    planes: jax.Array,
    ids: jax.Array,
    tie: jax.Array,
    qcoords: jax.Array,
    *,
    k: int,
    chunk: int,
    group: int,
    shift: int,
    qmax: int = QMAX,
    kernel: str | None = None,
    sig_rows: jax.Array | None = None,
    narrow_r: int = 0,
    num_bands: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Top-k by (asymmetric dot desc, id asc), grouped matmul path.

    Args:
        planes: ``(C, P)`` int8 ±1 store bitplanes (dead slots arbitrary).
        ids / tie: slot ids (-1 dead) and global tie keys.
        qcoords: ``(Q, P)`` int8 quantised query coordinates
            (:func:`quantize_coords_np` / `_jax`).
        shift: key right-shift from :func:`asymmetric_shift`.
        sig_rows: optional grouped word-major refine table
            (`lshrs_tpu.ops.scan.build_grouped_refine_rows`); the refine
            stage then gathers one wide row per candidate GROUP and
            reconstructs exact dots from the packed bits
            (:func:`refine_dots_from_words`) instead of gathering full
            bitplane rows. Requires ``num_bands`` (and ``narrow_r`` if
            the table is narrow-packed).
        kernel: group-max route (`lshrs_tpu.ops.pallas_scan.KERNEL_MODES`).
        num_bands: banding of ``sig_rows``'s word layout.

    Returns:
        ``(dots (Q, k) int32, out_ids (Q, k))``; empty tail entries carry
        id -1 and dots ``-(P*qmax + 1)``.
    """
    c, p = planes.shape
    q = qcoords.shape[0]
    scale = key_scale(c)
    offset = p * qmax

    gmax = dot_group_max_keys(
        planes, tie, qcoords,
        group=group, chunk=chunk, scale=scale, offset=offset, shift=shift,
        kernel=kernel,
    )

    # -- selection + exact refine ------------------------------------------
    ng = c // group
    m = min(k, ng)
    top_groups = _hierarchical_top_groups(gmax, m=m)
    mg = m * group
    # The word-row refine unrolls one select-accumulate per coordinate;
    # past a few thousand bits the unroll dominates compile time, so very
    # wide signatures keep the plane-gather formulation.
    if sig_rows is not None and p <= 2048:
        from lshrs_tpu.ops.bitpack import narrow_words_count
        from lshrs_tpu.ops.scan import gather_refine_group_rows

        assert num_bands is not None, "sig_rows refine requires num_bands"
        rows_per_band = p // num_bands
        nw = (
            narrow_words_count(num_bands, narrow_r)
            if narrow_r
            else num_bands * ((rows_per_band + 31) // 32)
        )
        cwords, cand_tie, cand_ids = gather_refine_group_rows(
            sig_rows, top_groups, bw=nw, group=group
        )
        dots = refine_dots_from_words(
            cwords, qcoords,
            num_bands=num_bands, rows_per_band=rows_per_band,
            narrow_r=narrow_r,
        ).reshape(q, mg)
        cand_tie = cand_tie.reshape(q, mg)
        cand_ids = cand_ids.reshape(q, mg)
        return _exact_pool_order(dots, cand_ids, cand_tie >= 0, k, offset)

    slots = (
        top_groups[..., None] * group + jnp.arange(group)[None, None, :]
    ).reshape(q, m * group)

    cand_planes = jnp.take(planes, slots.reshape(-1), axis=0).reshape(
        q, m * group, p
    )
    dots = jax.lax.dot_general(
        qcoords,
        cand_planes,
        dimension_numbers=(((1,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )  # (Q, m*group), exact (unshifted)
    cand_tie = jnp.take(tie, slots.reshape(-1)).reshape(q, m * group)
    cand_ids = jnp.take(ids, slots.reshape(-1)).reshape(q, m * group)
    return _exact_pool_order(dots, cand_ids, cand_tie >= 0, k, offset)


def asymmetric_topk_chunked_core(
    planes: jax.Array,
    ids: jax.Array,
    ranks: jax.Array,
    qcoords: jax.Array,
    *,
    k: int,
    chunk: int,
    qmax: int = QMAX,
) -> tuple[jax.Array, jax.Array]:
    """Chunked-selection fallback (capacity not group-aligned).

    Packs ``(dots + offset + 1) * chunk + rank`` per chunk — at the
    default chunk=2048 and P*qmax=32512 this fits int32 with NO shift, so
    the fallback is exact w.r.t. the unquantised (dots desc, id asc)
    ordering.
    """
    c, p = planes.shape
    q = qcoords.shape[0]
    offset = p * qmax
    if (2 * offset + 2) * chunk >= 2**31:
        raise ValueError(
            f"chunk {chunk} too wide for exact asymmetric packing at "
            f"num_perm*qmax={offset}"
        )
    nchunks = c // chunk
    k_chunk = min(k, chunk)

    planes_c = planes.reshape(nchunks, chunk, p)
    ids_c = ids.reshape(nchunks, chunk)
    ranks_c = ranks.reshape(nchunks, chunk)

    def body(carry, xs):
        chunk_planes, chunk_ids, chunk_ranks = xs
        dots = jax.lax.dot_general(
            qcoords,
            chunk_planes,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        scaled = jnp.where(chunk_ids[None, :] >= 0, dots + offset + 1, 0)
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
    dots = jnp.where(ids_out >= 0, scaled_out - offset - 1, -(offset + 1))
    return dots, ids_out


asymmetric_topk = partial(
    jax.jit,
    static_argnames=(
        "k", "chunk", "group", "shift", "qmax", "kernel", "narrow_r",
        "num_bands",
    ),
)(asymmetric_topk_core)
asymmetric_topk_chunked = partial(
    jax.jit, static_argnames=("k", "chunk", "qmax")
)(asymmetric_topk_chunked_core)
