"""Sub-linear bucketed query engine: sorted band keys + binary search.

This is the device realization of the reference's Redis bucket tables
(`(band, signature) -> set of ids`, `/root/reference/lshrs/storage/redis.py:40`).
Open-addressing hash tables need atomics and data-dependent probing — both
hostile to XLA — so buckets are materialised instead as *per-band sorted
key arrays*:

    keys[b, :]   uint32  folded band-b signature of every slot
    order[b, :]  int32   slot ids permuted so keys[b, order[b]] ascends
    skeys[b, :]  uint32  the sorted keys themselves

A query then runs entirely with static shapes:

    1. `searchsorted` per band (vectorised binary search over collective-free,
       shard-local data) -> start of the matching key run,
    2. take a fixed window of ``bucket_cap`` slots per band (runs longer
       than the window are truncated and *counted* — surfaced as an
       overflow statistic, the documented capacity/recall trade),
    3. deduplicate candidates (sort + first-occurrence mask),
    4. **verify**: gather the candidates' full packed signatures and
       recompute exact per-band collision counts — so folded-key
       collisions (W > 1 bands hash to 32 bits) and bucket merges can
       never corrupt results,
    5. exact (count desc, id asc) top-k via the same packed-key selection
       the scan engine uses.

Cost per query is O(num_bands * (log C + bucket_cap * BW)) — independent
of index size up to the search — versus the scan engine's O(C * BW).
Results are bit-identical to the scan engine whenever no bucket run
exceeds ``bucket_cap``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lshrs_tpu.ops.pallas_scan import key_scale

__all__ = ["build_bucket_index", "bucketed_topk"]

# Host-side constants: module import must not touch the device backend.
_INT32_MAX = np.int32(2**31 - 1)
_MIX = np.uint32(2654435761)  # Knuth multiplicative constant


def fold_band_keys(sig_t: jax.Array, *, num_bands: int) -> jax.Array:
    """Fold each band's W words into one uint32 bucket key, ``(B, C)``."""
    bw, c = sig_t.shape
    w = bw // num_bands
    banded = sig_t.reshape(num_bands, w, c)
    keys = banded[:, 0, :]
    for j in range(1, w):
        keys = (keys * _MIX) ^ banded[:, j, :]
    return keys


@partial(jax.jit, static_argnames=("num_bands",))
def build_bucket_index(
    sig_t: jax.Array, ids: jax.Array, *, num_bands: int
) -> tuple[jax.Array, jax.Array]:
    """Sorted per-band bucket index: ``(skeys (B, C), order (B, C))``.

    Dead slots get the maximal key so they cluster at the tail (and are
    dropped again during verification).
    """
    keys = fold_band_keys(sig_t, num_bands=num_bands)
    keys = jnp.where(ids[None, :] >= 0, keys, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(keys, axis=1).astype(jnp.int32)
    skeys = jnp.take_along_axis(keys, order, axis=1)
    return skeys, order


@partial(jax.jit, static_argnames=("num_bands", "k", "bucket_cap"))
def bucketed_topk(
    sig_t: jax.Array,
    ids: jax.Array,
    tie: jax.Array,
    skeys: jax.Array,
    order: jax.Array,
    qwords: jax.Array,
    *,
    num_bands: int,
    k: int,
    bucket_cap: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Exact top-k via bucket enumeration + verification.

    Args:
        sig_t / ids / tie: store state (see `lshrs_tpu.storage.device`).
        skeys / order: output of :func:`build_bucket_index`.
        qwords: ``(Q, BW)`` uint32 query signatures.
        bucket_cap: max slots taken per (query, band) bucket run.

    Returns:
        ``(counts (Q, k), out_ids (Q, k), overflows ())`` — exact
        (count desc, id asc) results plus the number of (query, band)
        bucket runs that were longer than ``bucket_cap`` (0 => results
        provably identical to the full scan).
    """
    bw, c = sig_t.shape
    w = bw // num_bands
    q = qwords.shape[0]
    scale = key_scale(c)

    qkeys = fold_band_keys(qwords.T, num_bands=num_bands)  # (B, Q)

    # 1. vectorised binary search per band
    lo = jax.vmap(jnp.searchsorted)(skeys, qkeys).astype(jnp.int32)  # (B, Q)

    # 2. fixed windows of candidate slots
    win = lo.T[:, :, None] + jnp.arange(bucket_cap, dtype=jnp.int32)  # (Q, B, L)
    win_clipped = jnp.minimum(win, c - 1)
    band_base = (jnp.arange(num_bands, dtype=jnp.int32) * c)[None, :, None]
    flat = (band_base + win_clipped).reshape(-1)
    hit = (
        jnp.take(skeys.reshape(-1), flat).reshape(q, num_bands, bucket_cap)
        == qkeys.T[:, :, None]
    ) & (win < c)
    slots = jnp.take(order.reshape(-1), flat).reshape(q, num_bands, bucket_cap)
    slots = jnp.where(hit, slots, _INT32_MAX)  # sentinel for misses

    # overflow detection: does the run continue past the window?
    past = jnp.minimum(lo.T + bucket_cap, c - 1)  # (Q, B)
    past_flat = (band_base[:, :, 0] + past).reshape(-1)
    overflow = (
        jnp.take(skeys.reshape(-1), past_flat).reshape(q, num_bands) == qkeys.T
    ) & (lo.T + bucket_cap < c)
    overflows = overflow.sum()

    # 3. deduplicate candidates per query (sort + first-occurrence mask)
    cand = jnp.sort(slots.reshape(q, num_bands * bucket_cap), axis=1)
    first = jnp.concatenate(
        [jnp.ones((q, 1), bool), cand[:, 1:] != cand[:, :-1]], axis=1
    )
    cand = jnp.where(first & (cand != _INT32_MAX), cand, c)  # c = dropped

    # 4. verification: exact band counts for the gathered candidates
    n_cand = cand.shape[1]
    safe = jnp.minimum(cand, c - 1)
    cand_sig = jnp.take(sig_t, safe.reshape(-1), axis=1).reshape(bw, q, n_cand)
    counts = None
    for b in range(num_bands):
        eq = cand_sig[b * w] == qwords[:, b * w][:, None]
        for j in range(1, w):
            eq &= cand_sig[b * w + j] == qwords[:, b * w + j][:, None]
        counts = eq.astype(jnp.int32) if counts is None else counts + eq
    cand_tie = jnp.take(tie, safe.reshape(-1)).reshape(q, n_cand)
    alive = (cand_tie >= 0) & (cand < c)
    key = counts * alive.astype(jnp.int32) * scale + jnp.where(alive, cand_tie, 0)

    # 5. exact selection
    k_eff = min(k, n_cand)
    top_key, top_pos = jax.lax.top_k(key, k_eff)
    sel_counts = top_key // scale
    sel_slots = jnp.take_along_axis(safe, top_pos, axis=1)
    sel_ids = jnp.where(
        sel_counts > 0, jnp.take(ids, sel_slots.reshape(-1)).reshape(q, k_eff), -1
    )
    if k_eff < k:
        sel_counts = jnp.pad(sel_counts, ((0, 0), (0, k - k_eff)))
        sel_ids = jnp.pad(sel_ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return sel_counts, sel_ids, overflows
