"""Device collision-counting and exact top-k selection.

This replaces the reference's query hot loop — one Redis SMEMBERS round-trip
per band plus a Python dict accumulate
(`/root/reference/lshrs/core/main.py:1088-1111`) — with fused device scans
over the device-resident signature store, kept in *transposed* layout
``sig_t: (num_bands * W, capacity)`` so the slot axis is minor and every
compare runs over contiguous slots.

Exact ordering contract: the reference sorts candidates by
``(-collision_count, index)`` (`/root/reference/lshrs/core/main.py:614`).
Plain ``lax.top_k`` breaks count ties by position, so selection keys embed
each slot's *id-rank*: ``key = count * S + (S - 1 - rank)`` with all keys
globally distinct. Two selection strategies share that key:

- **Grouped fast path** (`collision_topk_grouped`): count + key +
  64-slot group-max (`lshrs_tpu.ops.pallas_scan`);
  because keys are distinct, the top-k *groups by max* provably contain
  every true top-k slot, so only ``k * group`` candidate slots are
  re-scored and exactly sorted. Candidate traffic drops by ``group``x.
- **Chunked fallback** (`collision_topk`): static `lax.scan` over chunks
  with per-chunk ``rank`` tie-break keys and a final two-key lexicographic
  merge — used when the key does not fit int32
  (``(num_bands + 1) * next_pow2(C) >= 2**31``) or for tiny stores.

Both produce bit-identical results to the reference ordering. All shapes
are static: dead/empty slots carry id -1 and are masked; the host filters
zero counts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lshrs_tpu.ops.bitpack import narrow_words_count, pack_words_narrow
from lshrs_tpu.ops.pallas_scan import (
    collision_group_max_keys,
    key_scale,
    supports_fast_path,
)

__all__ = [
    "collision_topk",
    "collision_topk_core",
    "collision_counts",
    "collision_counts_core",
    "collision_nnz",
    "collision_nnz_core",
    "collision_topk_grouped_core",
    "collision_topk_grouped",
    "merge_topk_pools",
    "topk_wide",
    "topk_wide_2key",
    "compute_chunk_ranks",
    "compute_global_tie",
    "global_tie_core",
    "key_scale",
    "refine_counts_vs_query",
    "supports_fast_path",
]

# Host-side constant: module import must not touch the device backend.
_INT32_MAX = np.int32(2**31 - 1)


def _band_counts_t(
    sig_chunk_t: jax.Array, qwords: jax.Array, num_bands: int, probes: int = 1
) -> jax.Array:
    """Collision counts, transposed layout.

    Args:
        sig_chunk_t: ``(BW, chunk)`` uint32 packed signatures.
        qwords: ``(Q, probes * BW)`` uint32 query signatures, probe-major
            (probe t's band-b word j at ``t*BW + b*w + j``).
    Returns:
        ``(Q, chunk)`` int32 — number of bands matching ANY probe variant.
        Still ``<= num_bands``: a band's variants are pairwise distinct,
        so a slot's band words equal at most one of them and the sum over
        probes equals the per-band OR.
    """
    bw = sig_chunk_t.shape[0]
    w = bw // num_bands
    counts = None
    for t in range(probes):
        for b in range(num_bands):
            col = t * bw + b * w
            eq = sig_chunk_t[b * w, :][None, :] == qwords[:, col][:, None]
            for j in range(1, w):
                eq &= (
                    sig_chunk_t[b * w + j, :][None, :]
                    == qwords[:, col + j][:, None]
                )
            counts = eq.astype(jnp.int32) if counts is None else counts + eq
    return counts


def _band_counts_t_scan(
    sig_chunk_t: jax.Array, qwords: jax.Array, num_bands: int, probes: int = 1
) -> jax.Array:
    """Like :func:`_band_counts_t` but loops bands with `lax.fori_loop`
    (avoids unrolling very large band counts into huge programs)."""
    bw, chunk = sig_chunk_t.shape
    q = qwords.shape[0]
    w = bw // num_bands

    def body(b, counts):
        eq_sum = None
        for t in range(probes):
            col = t * bw + b * w
            eq = jax.lax.dynamic_slice_in_dim(sig_chunk_t, b * w, 1, 0)[0][
                None, :
            ] == (
                jax.lax.dynamic_slice_in_dim(qwords, col, 1, 1)[:, 0][:, None]
            )
            for j in range(1, w):
                eq &= jax.lax.dynamic_slice_in_dim(sig_chunk_t, b * w + j, 1, 0)[0][
                    None, :
                ] == jax.lax.dynamic_slice_in_dim(qwords, col + j, 1, 1)[:, 0][
                    :, None
                ]
            eq_i = eq.astype(jnp.int32)
            eq_sum = eq_i if eq_sum is None else eq_sum + eq_i
        return counts + eq_sum

    return jax.lax.fori_loop(0, num_bands, body, jnp.zeros((q, chunk), jnp.int32))


def band_counts_t(sig_chunk_t, qwords, num_bands, probes=1):
    if num_bands <= 64:
        return _band_counts_t(sig_chunk_t, qwords, num_bands, probes)
    return _band_counts_t_scan(sig_chunk_t, qwords, num_bands, probes)


# ---------------------------------------------------------------------------
# chunked exact scan (fallback path)
# ---------------------------------------------------------------------------


def collision_topk_core(
    sig_t: jax.Array,
    ids: jax.Array,
    ranks: jax.Array,
    qwords: jax.Array,
    *,
    num_bands: int,
    k: int,
    chunk: int,
    probes: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k by (count desc, id asc), chunked `lax.scan` selection.

    Args:
        sig_t: ``(BW, C)`` uint32, C a multiple of ``chunk``.
        ids: ``(C,)`` int32 slot ids, -1 for dead/empty slots.
        ranks: ``(C,)`` int32 rank of each slot's id *within its chunk*
            (see :func:`compute_chunk_ranks`).
        qwords: ``(Q, probes * BW)`` uint32, probe-major
            (see :func:`band_counts_t`).

    Returns:
        ``(counts, out_ids)``, each ``(Q, k)``; zero-count tail padding
        carries id -1.
    """
    bw, c_total = sig_t.shape
    nchunks = c_total // chunk
    q = qwords.shape[0]
    k_chunk = min(k, chunk)

    sig_c = jnp.moveaxis(sig_t.reshape(bw, nchunks, chunk), 1, 0)
    ids_c = ids.reshape(nchunks, chunk)
    ranks_c = ranks.reshape(nchunks, chunk)

    def body(carry, xs):
        chunk_sig_t, chunk_ids, chunk_ranks = xs
        counts = band_counts_t(chunk_sig_t, qwords, num_bands, probes)
        counts = jnp.where(chunk_ids[None, :] >= 0, counts, 0)
        # Packed selection key: count-major, then id-rank ascending. Fits
        # int32: count <= num_bands <= 2^16, chunk <= 2^14.
        key = counts * chunk + (chunk - 1 - chunk_ranks)[None, :]
        top_key, top_pos = jax.lax.top_k(key, k_chunk)
        sel_counts = top_key // chunk
        sel_ids = jnp.take_along_axis(
            jnp.broadcast_to(chunk_ids[None, :], (q, chunk)), top_pos, axis=1
        )
        return carry, (sel_counts, sel_ids)

    _, (pool_counts, pool_ids) = jax.lax.scan(body, 0, (sig_c, ids_c, ranks_c))
    pool_counts = jnp.moveaxis(pool_counts, 0, 1).reshape(q, -1)
    pool_ids = jnp.moveaxis(pool_ids, 0, 1).reshape(q, -1)
    return merge_topk_pools(pool_counts, pool_ids, k=k)


def merge_topk_pools(
    pool_counts: jax.Array, pool_ids: jax.Array, *, k: int
) -> tuple[jax.Array, jax.Array]:
    """Merge pooled (count, id) candidates to the exact global top-k.

    Ascending lexicographic sort by (-count, id); empty entries (count 0)
    are forced to the end via id = INT32_MAX. Used for both cross-chunk
    merges on one device and the cross-shard merge after an all-gather.
    """
    neg_counts = -pool_counts
    tie_ids = jnp.where(pool_counts > 0, pool_ids, _INT32_MAX)
    _, _, sorted_counts, sorted_ids = jax.lax.sort(
        (neg_counts, tie_ids, pool_counts, pool_ids), num_keys=2
    )
    out_k = min(k, sorted_counts.shape[1])
    counts_out = sorted_counts[:, :out_k]
    ids_out = jnp.where(counts_out > 0, sorted_ids[:, :out_k], -1)
    if out_k < k:  # pool smaller than k: pad
        pad = k - out_k
        counts_out = jnp.pad(counts_out, ((0, 0), (0, pad)))
        ids_out = jnp.pad(ids_out, ((0, 0), (0, pad)), constant_values=-1)
    return counts_out, ids_out


collision_topk = partial(
    jax.jit, static_argnames=("num_bands", "k", "chunk", "probes")
)(collision_topk_core)


# ---------------------------------------------------------------------------
# grouped exact fast path
# ---------------------------------------------------------------------------


def build_grouped_refine_rows(sig_rows_ext: jax.Array, *, group: int) -> jax.Array:
    """Per-slot refine table -> GROUP-ROW refine table.

    The refinement stage needs the rows of every slot in each selected
    group. Concatenating each group's ``group`` slot rows into ONE wide
    table row makes that refinement a gather of ``m`` wide rows per query
    instead of ``m * group`` narrow ones. Pure reshape/transpose, no data
    inflation. Groups are contiguous slot runs (group ``g`` holds slots
    ``[g * group, (g + 1) * group)``), as every group-max formulation
    produces them.

    Args:
        sig_rows_ext: ``(C, nc)`` uint32, ``nc = bw + 2`` (words|tie|id).
        group: slots per group.

    Returns:
        ``(C // group, nc * group)`` uint32; row ``g`` = group ``g``'s
        slot rows transposed to WORD-MAJOR order: ``nc`` contiguous
        ``group``-wide blocks (word 0 of every slot, then word 1, ...,
        then tie, then id), so the refinement reads each word column as
        one contiguous block.
    """
    c, nc = sig_rows_ext.shape
    r3 = sig_rows_ext.reshape(c // group, group, nc)
    return jnp.transpose(r3, (0, 2, 1)).reshape(c // group, nc * group)


def gather_refine_group_rows(
    rows_g: jax.Array, top_groups: jax.Array, *, bw: int, group: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Gather whole candidate-group rows -> ``(words, tie, ids)``.

    Args:
        rows_g: ``(C // group, (bw + 2) * group)`` uint32 word-major
            grouped refine table (see :func:`build_grouped_refine_rows`).
        top_groups: ``(Q, m)`` int32 selected group indices.

    Returns:
        ``words (Q, m, bw, group) uint32`` (``words[..., wi, :]`` is a
        contiguous, lane-aligned block), ``tie (Q, m, group) int32``,
        ``ids (Q, m, group) int32``. Flatten the trailing ``(m, group)``
        axes consistently to index candidates.
    """
    q, m = top_groups.shape
    nc = bw + 2
    rows = jnp.take(rows_g, top_groups.reshape(-1), axis=0)
    # Materialize the gather before the per-word column slices: fused with
    # its consumers, XLA re-expands the one wide row-gather into nc
    # element gathers.
    rows = jax.lax.optimization_barrier(rows).reshape(q, m, nc, group)
    words = rows[:, :, :bw, :]
    tie = jax.lax.bitcast_convert_type(rows[:, :, bw, :], jnp.int32)
    ids = jax.lax.bitcast_convert_type(rows[:, :, bw + 1, :], jnp.int32)
    return words, tie, ids


def refine_counts_vs_query(
    cwords: jax.Array,
    qwords: jax.Array,
    *,
    num_bands: int,
    words: int,
    narrow_r: int,
    probes: int = 1,
) -> jax.Array:
    """Per-candidate collision counts of gathered refine rows vs queries.

    Args:
        cwords: ``(Q, m, nw, group)`` uint32 gathered signature words —
            word-aligned (``nw = num_bands * words``) when ``narrow_r == 0``,
            else NARROW-packed (``32 // narrow_r`` bands per word, see
            `lshrs_tpu.ops.bitpack.pack_words_narrow`).
        qwords: ``(Q, probes * num_bands * words)`` uint32 probe-major,
            always word-aligned (packed narrow here when needed — a few
            shifts on ``(Q, BW)`` per probe).

    Returns:
        ``(Q, m, group)`` int32 matching-band counts (any-probe semantics
        when ``probes > 1``; see :func:`band_counts_t`).
    """
    bw = num_bands * words
    if narrow_r:
        q = qwords.shape[0]
        qn = pack_words_narrow(
            qwords.reshape(q * probes, bw),
            num_bands=num_bands,
            rows_per_band=narrow_r,
        ).reshape(q, probes, -1)
        bpw = 32 // narrow_r
        mask = jnp.uint32((1 << narrow_r) - 1)
        nw = cwords.shape[2]
        counts = None
        for t in range(probes):
            for wi in range(nw):
                cw = cwords[:, :, wi, :]
                qv = qn[:, t, wi][:, None, None]
                for j in range(min(bpw, num_bands - wi * bpw)):
                    sh = jnp.uint32(j * narrow_r)
                    eq = ((cw >> sh) & mask) == ((qv >> sh) & mask)
                    counts = (
                        eq.astype(jnp.int32) if counts is None else counts + eq
                    )
        return counts
    counts = None
    for t in range(probes):
        for b in range(num_bands):
            col = t * bw + b * words
            eq = cwords[:, :, b * words, :] == qwords[:, col][:, None, None]
            for j in range(1, words):
                eq &= (
                    cwords[:, :, b * words + j, :]
                    == qwords[:, col + j][:, None, None]
                )
            counts = eq.astype(jnp.int32) if counts is None else counts + eq
    return counts


def topk_wide(
    key: jax.Array, m: int, *, block: int = 256, flat: int = 1024
) -> tuple[jax.Array, jax.Array]:
    """Exact top-m ``(values, positions)`` over wide rows.

    XLA lowers a flat ``lax.top_k`` to a (partial) row sort whose cost
    grows superlinearly past a few thousand columns — at 4M slots the
    cascade's two wide selections (4096- and 8192-column ``top_k``)
    alone cost more than the exact engine's entire 256-bit scan. This
    selector instead keeps every ``block``-column block's local top-m
    per round (exact with NO key-distinctness assumption: every global
    top-m element is, by definition, its own block's local top-m),
    shrinking the row by ~``m/block`` per round until one cheap flat
    ``top_k`` finishes. Among equal keys lower positions win
    (``lax.top_k`` semantics), except that >m-way ties spanning a block
    boundary may resolve to a different equal-key position. Positions
    are only meaningful for values above the dtype minimum (internal
    padding value; all selection keys in this package are >= 0).
    """
    q, n = key.shape
    m = min(m, n)
    block = max(block, 2 * m)
    lowest = (
        jnp.iinfo(key.dtype).min
        if jnp.issubdtype(key.dtype, jnp.integer)
        else -jnp.inf
    )
    pos: jax.Array | None = None
    while n > max(flat, block):
        nb = -(-n // block)
        if nb * block != n:
            key = jnp.pad(
                key, ((0, 0), (0, nb * block - n)), constant_values=lowest
            )
        v, p = jax.lax.top_k(key.reshape(q * nb, block), m)
        p = (
            p.reshape(q, nb, m).astype(jnp.int32)
            + (jnp.arange(nb, dtype=jnp.int32) * block)[None, :, None]
        ).reshape(q, nb * m)
        pos = p if pos is None else jnp.take_along_axis(pos, p, axis=1)
        key = v.reshape(q, nb * m)
        n = key.shape[1]
    v, p = jax.lax.top_k(key, m)
    p = p.astype(jnp.int32)
    if pos is not None:
        p = jnp.take_along_axis(pos, p, axis=1)
    return v, p


def topk_wide_2key(
    primary: jax.Array,
    secondary: jax.Array,
    m: int,
    *,
    block: int = 256,
    flat: int = 1024,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Exact top-m by DESCENDING ``(primary, secondary)`` lexicographic order.

    The two-key analog of :func:`topk_wide`, with per-block stable
    ``lax.sort(num_keys=2)`` as the selector. This is the selection
    primitive for keys too wide to pack into one int32 — e.g. the
    Hamming refine past ``(num_perm + 2) * key_scale(C) >= 2**31``
    (capacity ~8M+ at num_perm=256) — replacing both the packed key and
    the rank-remap double ``argsort`` it previously required. Equal
    ``(primary, secondary)`` pairs resolve to the lowest position
    (stable sort; same block-boundary caveat as :func:`topk_wide`).
    Values must be > INT32_MIN (negated internally).

    Returns:
        ``(primary_sel, secondary_sel, positions)``, each ``(Q, m)``.
    """
    q, n = primary.shape
    m = min(m, n)
    block = max(block, 2 * m)
    np1 = -primary
    np2 = -secondary
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (q, n))
    big = jnp.iinfo(np1.dtype).max

    def keep_sorted(p1, p2, pp, keep):
        width = p1.shape[-1]
        s1, s2, sp = jax.lax.sort(
            (
                p1.reshape(-1, width),
                p2.reshape(-1, width),
                pp.reshape(-1, width),
            ),
            num_keys=2,
        )
        return s1[:, :keep], s2[:, :keep], sp[:, :keep]

    while n > max(flat, block):
        nb = -(-n // block)
        if nb * block != n:
            pad = ((0, 0), (0, nb * block - n))
            np1 = jnp.pad(np1, pad, constant_values=big)
            np2 = jnp.pad(np2, pad, constant_values=big)
            pos = jnp.pad(pos, pad)
        s1, s2, sp = keep_sorted(
            np1.reshape(q * nb, block),
            np2.reshape(q * nb, block),
            pos.reshape(q * nb, block),
            m,
        )
        np1 = s1.reshape(q, nb * m)
        np2 = s2.reshape(q, nb * m)
        pos = sp.reshape(q, nb * m)
        n = nb * m
    s1, s2, sp = keep_sorted(np1, np2, pos, m)
    return -s1, -s2, sp


def _pool_top_groups(gmax: jax.Array, *, m: int) -> jax.Array:
    """Approximate top-m group indices for a REFINE-POOL selection.

    The cascade's deep refine pool (``m`` in the hundreds) is a heuristic
    candidate set — the refine stage re-ranks everything in it with true
    full-width keys — so pool selection does not need the exact top-m by
    coarse key, only a set that contains (nearly) all of it. This uses
    ``jax.lax.approx_max_k``; on a GPU XLA lowers it to an exact sort, so
    there it costs what exact selection costs. Do NOT use for the exact
    single-pass engines' ``m = k`` selection — their provable-exactness
    argument needs the true top-k groups (:func:`_hierarchical_top_groups`).

    The float32 cast is a value conversion (monotone; keys within
    ``2**(bits-24)`` collapse) — it can merge near-tied id-rank bits,
    which only perturbs selection among coarse-tied groups; the refine
    stage re-ranks with the true (hamming, id) key either way.
    """
    q, ng = gmax.shape
    m = min(m, ng)
    _, idx = jax.lax.approx_max_k(gmax.astype(jnp.float32), m)
    return idx.astype(jnp.int32)


def _hierarchical_top_groups(gmax: jax.Array, *, m: int) -> jax.Array:
    """Exact top-m group indices from per-group max keys.

    For wide group-max rows a flat ``lax.top_k`` dominates selection cost
    (it scales badly past a few thousand columns), so select hierarchically:
    per-superchunk maxima -> top-m superchunks -> top-m groups within them.
    Exactness follows from globally distinct keys by the same argument as
    the group-max trick: every true top-m group lives in a top-m
    superchunk by max. Leaf selections go through :func:`topk_wide`, so
    wide leaves (e.g. the cascade's ``m * ngc`` candidate matrix at
    ``m = 64``) stay block-local instead of full-row sorts.
    """
    q, ng = gmax.shape
    ngc = min(ng, 128)
    # XLA's flat top_k cost grows superlinearly past ~2k columns; the
    # hierarchy is effectively free, so prefer it whenever it applies.
    if ng < 2048 or ng % ngc != 0 or ng // ngc <= m:
        return topk_wide(gmax, m)[1]
    nch = ng // ngc
    g3 = gmax.reshape(q, nch, ngc)
    chunk_max = g3.max(axis=-1)
    mc = min(m, nch)
    _, top_chunks = topk_wide(chunk_max, mc)  # (Q, mc)
    cand = jnp.take_along_axis(g3, top_chunks[..., None], axis=1)  # (Q, mc, ngc)
    _, pos = topk_wide(cand.reshape(q, mc * ngc), m)
    ci_sel = jnp.take_along_axis(top_chunks, pos // ngc, axis=1)
    return ci_sel * ngc + pos % ngc


def collision_topk_grouped_core(
    sig_t: jax.Array,
    ids: jax.Array,
    tie: jax.Array,
    qwords: jax.Array,
    *,
    num_bands: int,
    k: int,
    group: int,
    kernel: str | None = None,
    sig_rows: jax.Array | None = None,
    narrow_r: int = 0,
    probes: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k via group-max keys + candidate-group refinement.

    Args:
        sig_t: ``(BW, C)`` uint32 transposed signatures; C % group == 0.
        ids: ``(C,)`` int32, -1 dead.
        tie: ``(C,)`` int32 — ``S - 1 - global_id_rank`` for alive slots,
            -1 for dead (see :func:`compute_global_tie`).
        kernel: group-max route (`lshrs_tpu.ops.pallas_scan.KERNEL_MODES`);
            None is the plain XLA formulation.
        sig_rows: optional ``(C // group, group * (nw + 2))`` GROUPED
            refine table (see :func:`build_grouped_refine_rows`). When
            given, the refinement gathers one wide row per candidate
            GROUP — all its slots' words, ties and ids together — instead
            of ``group`` per-slot gathers.
        narrow_r: 0 when ``sig_rows`` carries word-aligned words
            (``nw = BW``); else ``rows_per_band``, meaning the table is
            narrow-packed (``nw = narrow_words_count(...)`` — see
            `lshrs_tpu.ops.bitpack.pack_words_narrow`; refine-gather
            traffic halves at r=16).
        probes: multi-probe variants per query; ``qwords`` is then
            ``(Q, probes * BW)`` probe-major and the count is the number
            of bands matching ANY variant (still ``<= num_bands``, so the
            key packing is unchanged — see :func:`band_counts_t`).
    """
    bw, c = sig_t.shape
    q = qwords.shape[0]
    w = bw // num_bands
    scale = key_scale(c)
    ng = c // group

    gmax = collision_group_max_keys(
        sig_t, tie, qwords,
        num_bands=num_bands, words=w, group=group, scale=scale,
        probes=probes, kernel=kernel,
    )

    # Top-k groups by max provably contain every true top-k slot (keys are
    # globally distinct), so re-scoring their k*group slots is exact.
    m = min(k, ng)
    top_groups = _hierarchical_top_groups(gmax, m=m)
    mg = m * group
    if sig_rows is not None:
        nw = narrow_words_count(num_bands, narrow_r) if narrow_r else bw
        cwords, cand_tie, cand_ids = gather_refine_group_rows(
            sig_rows, top_groups, bw=nw, group=group
        )
        slots = None
        counts = refine_counts_vs_query(
            cwords, qwords, num_bands=num_bands, words=w, narrow_r=narrow_r,
            probes=probes,
        ).reshape(q, mg)
        cand_tie = cand_tie.reshape(q, mg)
        cand_ids = cand_ids.reshape(q, mg)
    else:
        slots = (
            top_groups[..., None] * group + jnp.arange(group)[None, None, :]
        ).reshape(q, m * group)  # (Q, m*group)
        cand_sig = jnp.take(sig_t, slots.reshape(-1), axis=1).reshape(bw, q, mg)
        counts = None
        for t in range(probes):
            for b in range(num_bands):
                col = t * bw + b * w
                eq = cand_sig[b * w] == qwords[:, col][:, None]
                for j in range(1, w):
                    eq &= cand_sig[b * w + j] == qwords[:, col + j][:, None]
                counts = eq.astype(jnp.int32) if counts is None else counts + eq
        cand_tie = jnp.take(tie, slots.reshape(-1)).reshape(q, mg)
        cand_ids = None
    key = counts * (cand_tie >= 0).astype(jnp.int32) * scale + jnp.maximum(cand_tie, 0)

    k_eff = min(k, mg)
    top_key, top_pos = topk_wide(key, k_eff)
    sel_counts = top_key // scale
    if cand_ids is not None:
        picked = jnp.take_along_axis(cand_ids, top_pos, axis=1)
    else:
        sel_slots = jnp.take_along_axis(slots, top_pos, axis=1)
        picked = jnp.take(ids, sel_slots.reshape(-1)).reshape(q, k_eff)
    sel_ids = jnp.where(sel_counts > 0, picked, -1)
    if k_eff < k:
        sel_counts = jnp.pad(sel_counts, ((0, 0), (0, k - k_eff)))
        sel_ids = jnp.pad(sel_ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return sel_counts, sel_ids


collision_topk_grouped = partial(
    jax.jit,
    static_argnames=("num_bands", "k", "group", "kernel", "narrow_r", "probes"),
)(collision_topk_grouped_core)


# ---------------------------------------------------------------------------
# full counts (unbounded-candidate paths)
# ---------------------------------------------------------------------------


def collision_counts_core(
    sig_t: jax.Array,
    ids: jax.Array,
    qwords: jax.Array,
    *,
    num_bands: int,
    chunk: int,
    probes: int = 1,
) -> jax.Array:
    """Full per-slot collision counts, ``(Q, C)`` int32 (0 at dead slots).

    Used by the unbounded-candidate paths (``top_k=None`` and top-p rerank),
    where the caller needs every colliding candidate, exactly like the
    reference's candidate dict — but computed in one device pass.
    """
    bw, c_total = sig_t.shape
    nchunks = c_total // chunk
    q = qwords.shape[0]
    sig_c = jnp.moveaxis(sig_t.reshape(bw, nchunks, chunk), 1, 0)
    ids_c = ids.reshape(nchunks, chunk)

    def body(carry, xs):
        chunk_sig_t, chunk_ids = xs
        counts = band_counts_t(chunk_sig_t, qwords, num_bands, probes)
        counts = jnp.where(chunk_ids[None, :] >= 0, counts, 0)
        return carry, counts

    _, all_counts = jax.lax.scan(body, 0, (sig_c, ids_c))  # (nchunks, Q, chunk)
    return jnp.moveaxis(all_counts, 0, 1).reshape(q, c_total)


collision_counts = partial(
    jax.jit, static_argnames=("num_bands", "chunk", "probes")
)(collision_counts_core)


def collision_nnz_core(
    sig_t: jax.Array,
    ids: jax.Array,
    qwords: jax.Array,
    *,
    num_bands: int,
    chunk: int,
    probes: int = 1,
) -> jax.Array:
    """Per-query colliding-candidate count, ``(Q,)`` int32.

    The reduction happens inside the chunk scan, so nothing ``(Q, C)``
    ever materialises — this is what lets the unbounded-candidate API
    (``top_k=None``) verify a bounded enumeration's completeness with
    ``O(Q)`` readback instead of the reference-shaped ``O(Q, C)`` count
    matrix (`/root/reference/lshrs/core/main.py:605-614` reads the whole
    candidate dict).
    """
    bw, c_total = sig_t.shape
    nchunks = c_total // chunk
    q = qwords.shape[0]
    sig_c = jnp.moveaxis(sig_t.reshape(bw, nchunks, chunk), 1, 0)
    ids_c = ids.reshape(nchunks, chunk)

    def body(acc, xs):
        chunk_sig_t, chunk_ids = xs
        counts = band_counts_t(chunk_sig_t, qwords, num_bands, probes)
        hit = (counts > 0) & (chunk_ids[None, :] >= 0)
        return acc + hit.sum(axis=1, dtype=jnp.int32), None

    acc, _ = jax.lax.scan(body, jnp.zeros((q,), jnp.int32), (sig_c, ids_c))
    return acc


collision_nnz = partial(
    jax.jit, static_argnames=("num_bands", "chunk", "probes")
)(collision_nnz_core)


# ---------------------------------------------------------------------------
# rank / tie maintenance
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("chunk",))
def compute_chunk_ranks(ids: jax.Array, *, chunk: int) -> jax.Array:
    """Rank of each slot's id within its chunk (dead slots included).

    ``rank[i]`` is order-isomorphic to ``ids[i]`` among the slots of the
    same chunk, which is all the chunked fallback needs for exact id
    tie-breaking. Deletions don't disturb surviving slots' relative order.
    """
    c_total = ids.shape[0]
    ids2 = ids.reshape(c_total // chunk, chunk)
    order = jnp.argsort(ids2, axis=-1)
    ranks = jnp.argsort(order, axis=-1)
    return ranks.reshape(c_total).astype(jnp.int32)


def global_tie_core(ids: jax.Array) -> jax.Array:
    """Global tie-break keys: ``S - 1 - rank(id)`` for alive slots, -1 dead.

    Ranks are computed over all slots (dead ids sort as -1, ahead of alive
    ones — order isomorphism among alive slots is all that matters). The
    scale is derived from ``ids.shape``, so inside `shard_map` this
    produces per-shard keys consistent with the shard-local scan.
    """
    c = ids.shape[0]
    scale = key_scale(c)
    order = jnp.argsort(ids)
    rank = jnp.argsort(order).astype(jnp.int32)
    return jnp.where(ids >= 0, scale - 1 - rank, -1)


compute_global_tie = jax.jit(global_tie_core)
