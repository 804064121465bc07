"""Device-fused cosine rerank over the device-resident payload matrix.

The reference's top-p mode round-trips every candidate through a
user-supplied ``vector_fetch_fn`` and reranks on host
(`/root/reference/lshrs/core/main.py:632-647`). With ``store_vectors=True``
the payload lives in device memory, so rerank is one matvec over the store
plus a masked two-key sort — only the top ``max_out`` (id, score) pairs and
the candidate count ever reach the host.

Ordering: (cosine desc, id asc) — deterministic where the reference's
argpartition-based tie handling is not; identical whenever scores are
distinct.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "rerank_topp_core",
    "rerank_topp",
    "rerank_topp_batch_core",
    "rerank_topp_batch",
    "rerank_topp_gather_core",
    "rerank_topp_gather",
]

# Host-side constant: module import must not touch the device backend.
_INT32_MAX = np.int32(2**31 - 1)


def rerank_topp_core(
    payload: jax.Array,
    pnorm: jax.Array,
    ids: jax.Array,
    counts_row: jax.Array,
    qvec: jax.Array,
    *,
    max_out: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Rank colliding candidates by cosine similarity, on device.

    Args:
        payload: ``(C, dim)`` float32 raw vectors (dead slots arbitrary).
        pnorm: ``(C,)`` float32 precomputed L2 norms of payload rows.
        ids: ``(C,)`` int32, -1 dead.
        counts_row: ``(C,)`` int32 band-collision counts for this query.
        qvec: ``(dim,)`` float32 query.
        max_out: ranked prefix length to return.

    Returns:
        ``(ids (max_out,), sims (max_out,), n_candidates ())`` — candidates
        ordered by (cosine desc, id asc); entries past ``n_candidates``
        carry id -1.
    """
    # HIGHEST precision: default-precision float32 matmuls may run reduced
    # (bf16 passes or TF32, ~1e-3 relative error) — the reference computes
    # cosines in host float32, and ~1e-3 noise visibly reorders near-ties.
    # HIGHEST is true float32 on every backend. A bfloat16 payload is
    # already rounded, so it keeps the fast native path. An int8 payload
    # (per-row-scale quantized, see DeviceStore) upcasts to bf16 for the
    # matmul; its ``pnorm`` is the norm of the stored integer rows, so the
    # per-row scale cancels out of the cosine.
    if payload.dtype == jnp.int8:
        payload = payload.astype(jnp.bfloat16)
    bf16_payload = payload.dtype == jnp.bfloat16
    dots = jnp.dot(
        payload,
        qvec.astype(payload.dtype) if bf16_payload else qvec,
        preferred_element_type=jnp.float32,
        precision=None if bf16_payload else jax.lax.Precision.HIGHEST,
    )  # (C,) matvec
    qn = jnp.sqrt(jnp.sum(qvec * qvec))
    denom = jnp.maximum(pnorm * qn, 1e-30)
    sims = dots / denom
    mask = (counts_row > 0) & (ids >= 0)
    n = mask.sum()
    neg = jnp.where(mask, -sims, jnp.inf)
    tie = jnp.where(mask, ids, _INT32_MAX)
    _, _, sorted_sims, sorted_ids = jax.lax.sort((neg, tie, sims, ids), num_keys=2)
    out = min(max_out, sorted_ids.shape[0])
    out_ids = jnp.where(
        jnp.arange(out) < n, sorted_ids[:out], -1
    )
    return out_ids, sorted_sims[:out], n


rerank_topp = partial(jax.jit, static_argnames=("max_out",))(rerank_topp_core)


def rerank_topp_batch_core(
    payload: jax.Array,
    pnorm: jax.Array,
    ids: jax.Array,
    counts: jax.Array,
    qvecs: jax.Array,
    *,
    max_out: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched :func:`rerank_topp_core`: one matmul for all queries.

    Args:
        counts: ``(Q, C)`` int32 per-query collision counts.
        qvecs: ``(Q, dim)`` float32 queries.

    Returns:
        ``(ids (Q, max_out), sims (Q, max_out), n (Q,))`` per query,
        ordered by (cosine desc, id asc).

    Precision: float32 queries against a float32 payload get a
    HIGHEST-precision matmul, true float32 (default precision may run
    bf16 passes or TF32 with ~1e-3 relative error — enough to reorder
    near-ties vs the reference's host-f32 cosines). Inputs that *arrive* rounded — a
    bfloat16 query wire or a bfloat16 resident payload — keep the fast
    native-precision path.
    """
    if payload.dtype == jnp.int8:
        # Quantized payload (see DeviceStore): bf16 matmul; the per-row
        # quantization scale cancels out of the cosine because pnorm is
        # the stored integer rows' norm.
        payload = payload.astype(jnp.bfloat16)
    exact = qvecs.dtype == jnp.float32 and payload.dtype == jnp.float32
    bf16_payload = payload.dtype == jnp.bfloat16
    qd = qvecs.astype(payload.dtype) if bf16_payload else qvecs.astype(jnp.float32)
    qvecs = qvecs.astype(jnp.float32)
    dots = jnp.dot(
        qd,
        payload.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST if exact else None,
    )  # (Q, C)
    qn = jnp.sqrt(jnp.sum(qvecs * qvecs, axis=1, keepdims=True))
    denom = jnp.maximum(pnorm[None, :] * qn, 1e-30)
    sims = dots / denom
    mask = (counts > 0) & (ids >= 0)[None, :]
    n = mask.sum(axis=1)
    q, c = sims.shape
    out = min(max_out, c)
    if out <= 1024 < c:
        # Fast path: value-exact top_k on masked sims, then an exact
        # (cosine desc, id asc) sort of the small selected set. Ordering
        # among *exactly equal* cosines straddling the cut is unspecified
        # (the reference's argpartition has the same property); everywhere
        # else this is identical to the full sort.
        msims = jnp.where(mask, sims, -jnp.inf)
        top_sims, top_pos = jax.lax.top_k(msims, out)
        sel_ids = jnp.take(ids, top_pos)
        sel_mask = jnp.take_along_axis(mask, top_pos, axis=1)
        neg = jnp.where(sel_mask, -top_sims, jnp.inf)
        tie = jnp.where(sel_mask, sel_ids, _INT32_MAX)
        _, _, sorted_sims, sorted_ids = jax.lax.sort(
            (neg, tie, top_sims, sel_ids), num_keys=2
        )
    else:
        neg = jnp.where(mask, -sims, jnp.inf)
        ids_b = jnp.broadcast_to(ids[None, :], mask.shape)
        tie = jnp.where(mask, ids_b, _INT32_MAX)
        _, _, sorted_sims, sorted_ids = jax.lax.sort(
            (neg, tie, sims, ids_b), num_keys=2
        )
    out_ids = jnp.where(
        jnp.arange(out)[None, :] < n[:, None], sorted_ids[:, :out], -1
    )
    return out_ids, sorted_sims[:, :out], n


rerank_topp_batch = partial(jax.jit, static_argnames=("max_out",))(
    rerank_topp_batch_core
)


def rerank_topp_gather_core(
    payload: jax.Array,
    pnorm: jax.Array,
    ids: jax.Array,
    tie: jax.Array,
    sig_t: jax.Array,
    qwords: jax.Array,
    qvecs: jax.Array,
    *,
    num_bands: int,
    max_out: int,
    max_candidates: int,
    group: int,
    kernel: str | None = None,
    sig_rows: jax.Array | None = None,
    narrow_r: int = 0,
    probes: int = 1,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Candidate-gather top-p rerank: cost scales with CANDIDATES, not capacity.

    The full-store formulation (`rerank_topp_batch_core`) computes a
    ``(Q, C)`` cosine matmul and masks afterwards — brute-force kNN cost
    that throws away LSH's selectivity past ~100k slots. This core keeps
    the reference's candidates-only principle
    (`/root/reference/lshrs/core/main.py:633-647`) on device:

        1. group-max collision keys over the store (the same fused
           stage the top-k fast path uses — elementwise compares,
           ~``dim/num_words`` x fewer FLOPs than the cosine matmul),
        2. top-``max_candidates`` groups by max key; because keys are
           globally distinct, every group containing a colliding slot
           outranks every collision-free group, so whenever fewer than
           ``max_candidates`` groups contain collisions the candidate set
           is COVERED in full (detected exactly, see below),
        3. refine those groups' slots (counts / tie / id), select the top
           ``max_candidates`` slots by ``(count, tie)``,
        4. gather ONLY those slots' payload rows — ``(Q, M, dim)`` — and
           rerank with one small batched matmul + exact
           (cosine desc, id asc) sort.

    Args:
        payload / pnorm / ids / tie / sig_t: store state (see `DeviceStore`).
        qwords: ``(Q, probes * BW)`` uint32 query signatures (probe-major
            multi-probe layout when ``probes > 1`` — candidate sets then
            include any-probe band matches; see
            `lshrs_tpu.ops.scan.band_counts_t`).
        qvecs: ``(Q, dim)`` float32 (or bfloat16 wire) queries.
        max_out: ranked prefix length per query.
        max_candidates: M — groups refined and slots reranked per query.
        group / kernel / sig_rows: fast-path
            geometry, exactly as `collision_topk_grouped_core`.

    Returns:
        ``(ids (Q, max_out), sims (Q, max_out), n (Q,), exact (Q,))``.
        ``exact[q]`` is True iff query q's FULL colliding candidate set was
        reranked (guaranteed identical to the full-store formulation);
        otherwise the ranking covers the ``max_candidates`` candidates with
        the most band collisions and ``n`` is a lower bound. Exactness
        detection: if the worst selected group's max key is below the
        collision scale, some selected group is collision-free, hence every
        collision group was selected.
    """
    from lshrs_tpu.ops.bitpack import narrow_words_count
    from lshrs_tpu.ops.pallas_scan import collision_group_max_keys, key_scale
    from lshrs_tpu.ops.scan import (
        _hierarchical_top_groups,
        gather_refine_group_rows,
        refine_counts_vs_query,
    )

    bw, c = sig_t.shape
    q = qwords.shape[0]
    w = bw // num_bands
    scale = key_scale(c)
    ng = c // group

    # -- stage 1: group-max keys (shared with the collision fast path) ------
    gmax = collision_group_max_keys(
        sig_t, tie, qwords,
        num_bands=num_bands, words=w, group=group, scale=scale,
        probes=probes, kernel=kernel,
    )

    # -- stage 2: top-M groups + coverage detection -------------------------
    m = min(max_candidates, ng)
    top_groups = _hierarchical_top_groups(gmax, m=m)
    gsel = jnp.take_along_axis(gmax, top_groups, axis=1)  # (Q, m)
    covered = (gsel.min(axis=1) < scale) | (m == ng)

    # -- stage 3: refine selected groups ------------------------------------
    mg = m * group
    slots = (
        top_groups[..., None] * group + jnp.arange(group)[None, None, :]
    ).reshape(q, mg)
    if sig_rows is not None:
        # One wide row-gather per candidate group (8x faster than per-slot
        # gathers at 1M slots); slot order matches the arithmetic `slots`.
        nw = narrow_words_count(num_bands, narrow_r) if narrow_r else bw
        cwords, cand_tie, cand_ids = gather_refine_group_rows(
            sig_rows, top_groups, bw=nw, group=group
        )
        counts = refine_counts_vs_query(
            cwords, qwords, num_bands=num_bands, words=w, narrow_r=narrow_r,
            probes=probes,
        ).reshape(q, mg)
        cand_tie = cand_tie.reshape(q, mg)
        cand_ids = cand_ids.reshape(q, mg)
    else:
        cand_sig = jnp.take(sig_t, slots.reshape(-1), axis=1).reshape(bw, q, mg)
        counts = None
        for t in range(probes):
            for b in range(num_bands):
                col = t * bw + b * w
                eq = cand_sig[b * w] == qwords[:, col][:, None]
                for jj in range(1, w):
                    eq &= cand_sig[b * w + jj] == qwords[:, col + jj][:, None]
                counts = eq.astype(jnp.int32) if counts is None else counts + eq
        cand_tie = jnp.take(tie, slots.reshape(-1)).reshape(q, mg)
        cand_ids = jnp.take(ids, slots.reshape(-1)).reshape(q, mg)

    alive = cand_tie >= 0
    colliding = (counts > 0) & alive
    n = colliding.sum(axis=1)  # exact iff covered

    # -- stage 4: top-M slots by (count, tie), gather payload, rerank -------
    # (A two-level per-group pre-selection was tried here and measured
    # STRICTLY slower — XLA lowers even k=8 top_k over a tiny minor axis
    # to a sort, so the extra pass doubles the sort work. The flat top-M
    # is the fastest exact formulation measured.)
    m_slots = min(max_candidates, mg)
    key = counts * alive.astype(jnp.int32) * scale + jnp.maximum(cand_tie, 0)
    top_key, top_pos = jax.lax.top_k(key, m_slots)
    sel_counts = top_key // scale
    sel_slots = jnp.take_along_axis(slots, top_pos, axis=1)
    sel_ids = jnp.take_along_axis(cand_ids, top_pos, axis=1)
    exact = covered & (n <= m_slots)

    dim = payload.shape[1]
    # The gather stays in the payload's storage dtype (an int8 payload
    # moves 4x fewer gather bytes than f32); quantized rows upcast to
    # bf16 only for the small (Q, M, dim) matmul block.
    rows = jnp.take(payload, sel_slots.reshape(-1), axis=0).reshape(
        q, m_slots, dim
    )
    pn = jnp.take(pnorm, sel_slots.reshape(-1)).reshape(q, m_slots)

    # Precision contract mirrors rerank_topp_batch_core: f32 x f32 runs
    # HIGHEST (value-exact vs the reference's host-f32 cosines); inputs
    # that arrive rounded (bf16 wire / bf16 or int8 payload) keep the
    # native path.
    value_exact = qvecs.dtype == jnp.float32 and payload.dtype == jnp.float32
    if payload.dtype == jnp.int8:
        rows = rows.astype(jnp.bfloat16)
    bf16_payload = rows.dtype == jnp.bfloat16
    qd = qvecs.astype(rows.dtype) if bf16_payload else qvecs.astype(jnp.float32)
    qvecs_f32 = qvecs.astype(jnp.float32)
    dots = jnp.einsum(
        "qmd,qd->qm",
        rows,
        qd,
        precision=jax.lax.Precision.HIGHEST if value_exact else None,
        preferred_element_type=jnp.float32,
    )
    qn = jnp.sqrt(jnp.sum(qvecs_f32 * qvecs_f32, axis=1, keepdims=True))
    denom = jnp.maximum(pn * qn, 1e-30)
    sims = dots / denom

    mask = sel_counts > 0
    neg = jnp.where(mask, -sims, jnp.inf)
    tie_id = jnp.where(mask, sel_ids, _INT32_MAX)
    _, _, sorted_sims, sorted_ids = jax.lax.sort(
        (neg, tie_id, sims, sel_ids), num_keys=2
    )
    out = min(max_out, m_slots)
    # valid = colliding candidates actually SELECTED (== n when exact;
    # smaller under group/coverage truncation — never expose junk slots).
    valid = mask.sum(axis=1)
    out_ids = jnp.where(
        jnp.arange(out)[None, :] < valid[:, None], sorted_ids[:, :out], -1
    )
    out_sims = sorted_sims[:, :out]
    if out < max_out:
        out_ids = jnp.pad(
            out_ids, ((0, 0), (0, max_out - out)), constant_values=-1
        )
        out_sims = jnp.pad(out_sims, ((0, 0), (0, max_out - out)))
    return out_ids, out_sims, n, exact


rerank_topp_gather = partial(
    jax.jit,
    static_argnames=(
        "num_bands", "max_out", "max_candidates", "group", "kernel",
        "narrow_r", "probes",
    ),
)(rerank_topp_gather_core)
