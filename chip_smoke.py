"""End-to-end smoke run of lshrs_tpu on one NVIDIA GPU.

Drives the public API (``from lshrs_tpu import LSHRS``) at deployment
sizes and checks every answer against a plain NumPy reference that is
independent of the engine: band equality, popcount Hamming and integer
dots over the signatures the store actually holds (read back from the
device), and float64 cosine for the rerank. Data is synthesised on the
device from ``--seed``.

    python chip_smoke.py               # four phases on one card
    python chip_smoke.py --four-cards  # sharded store vs one card only

Phases (one card):

1. collision top-k, 100k x 768d, 16x16 bands: exact ``(-count, id)``;
2. auto -> Hamming at 1,048,576 x 768d with an f32 payload: exact
   ``(hamming, id)`` top-k, top-p rerank against float64 cosine, and the
   asymmetric estimator against NumPy integer dots;
3. Hamming cascade at 4,194,304 x 768d: planted recall@10 and overlap
   with the exact Hamming order;
4. hash agreement: host vs device hash, fused build vs query hash.

Every phase prints one ``phase ...`` line. Any failed check raises, so
the script exits non-zero; the last line of a passing run is the JSON
device record. Exits 2 without printing a result when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DIM = 768
NUM_BANDS, ROWS_PER_BAND = 16, 16
TOP_K = 10
QUERY_BATCH = 8192
N_CHECK = 256  # rows of each served batch compared with the reference
TOPP_P = 0.2
TOPP_TOL = 1e-5  # f32 HIGHEST cosines (true float32, not TF32) vs float64
HASH_BIT_TOL = 1e-4  # share of signature bits allowed to differ
PLANTED_RECALL_MIN = 0.99
_POOL = 8


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# plain NumPy references
# ---------------------------------------------------------------------------


def _per_query(fn, n: int) -> list:
    """``[fn(i) for i in range(n)]`` on a thread pool (NumPy releases the GIL)."""
    with ThreadPoolExecutor(_POOL) as pool:
        return list(pool.map(fn, range(n)))


def _order(primary: np.ndarray, ids: np.ndarray, k: int) -> np.ndarray:
    """Ids of the ``k`` smallest ``(primary, id)`` pairs, in order."""
    if primary.size > 4 * k:
        kth = np.partition(primary, k - 1)[k - 1]
        keep = primary <= kth
        primary, ids = primary[keep], ids[keep]
    return ids[np.lexsort((ids, primary))][:k]


def ref_collision_topk(
    sig: np.ndarray, ids: np.ndarray, qwords: np.ndarray, *, num_bands: int, k: int
) -> np.ndarray:
    """``(-count, id)`` top-k ids over band-equality counts (-1 padded).

    ``sig``: ``(n, BW)`` uint32 stored words of the alive slots, ``ids``
    their ids; ``qwords``: ``(Q, BW)``. Only colliding slots rank.
    """
    wpb = sig.shape[1] // num_bands

    def one(i):
        eq = (sig == qwords[i]).reshape(-1, num_bands, wpb).all(-1)
        count = eq.sum(-1)
        hit = count > 0
        got = _order(-count[hit], ids[hit], k)
        return np.pad(got, (0, k - got.size), constant_values=-1)

    return np.stack(_per_query(one, qwords.shape[0]))


def _as_u64(words: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(words, dtype=np.uint32)
    if w.shape[1] % 2:
        w = np.pad(w, ((0, 0), (0, 1)))
    return w.view(np.uint64)


def ref_hamming(sig: np.ndarray, qwords: np.ndarray) -> list:
    """Per query, the ``(n,)`` Hamming distances to every stored row."""
    s64, q64 = _as_u64(sig), _as_u64(qwords)

    def one(i):
        return np.bitwise_count(s64 ^ q64[i]).sum(axis=1, dtype=np.int32)

    return _per_query(one, q64.shape[0])


def ref_hamming_topk(
    sig: np.ndarray, ids: np.ndarray, qwords: np.ndarray, *, k: int
) -> np.ndarray:
    """``(hamming, id)`` top-k ids over the stored rows."""
    dists = ref_hamming(sig, qwords)
    return np.stack([_order(d, ids, k) for d in dists])


def unpack_planes(words: np.ndarray, *, num_bands: int, rows_per_band: int) -> np.ndarray:
    """``(n, BW)`` uint32 words -> ``(n, num_bands * rows_per_band)`` float32
    ±1 planes, bit ``j`` of band ``b`` at column ``b * rows_per_band + j``."""
    n = words.shape[0]
    w = words.reshape(n, num_bands, -1)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(n, num_bands, -1)[:, :, :rows_per_band]
    return (2.0 * bits - 1.0).astype(np.float32).reshape(n, -1)


def ref_asymmetric_dots(planes: np.ndarray, qi8: np.ndarray) -> np.ndarray:
    """``(Q, n)`` integer dots of quantised coordinates with ±1 planes.

    Float32 BLAS is exact here: every partial sum is an integer of
    magnitude below ``P * 127 < 2**24``.
    """
    return (qi8.astype(np.float32) @ planes.T).astype(np.int64)


def ref_topp(
    x: np.ndarray,
    ids: np.ndarray,
    sig: np.ndarray,
    qvecs: np.ndarray,
    qwords: np.ndarray,
    *,
    num_bands: int,
    p: float,
    max_out: int,
) -> list:
    """Per query ``(ids, cosines)``: colliding candidates ordered by float64
    ``(cosine desc, id asc)``, cut at ``max(1, ceil(p * n))``."""
    wpb = sig.shape[1] // num_bands
    xn = np.linalg.norm(x.astype(np.float64), axis=1)

    def one(i):
        hit = (sig == qwords[i]).reshape(-1, num_bands, wpb).all(-1).any(-1)
        cand = np.flatnonzero(hit)
        if cand.size == 0:
            return np.zeros(0, np.int64), np.zeros(0)
        q = qvecs[i].astype(np.float64)
        cos = (x[cand].astype(np.float64) @ q) / (xn[cand] * np.linalg.norm(q))
        order = np.lexsort((ids[cand], -cos))
        limit = min(max(1, math.ceil(cand.size * p)), max_out)
        return ids[cand][order][:limit], cos[order][:limit]

    return _per_query(one, qwords.shape[0])


def bit_share(a: np.ndarray, b: np.ndarray) -> float:
    """Share of signature bits that differ between two word arrays."""
    a, b = np.asarray(a, np.uint32), np.asarray(b, np.uint32)
    return float(np.bitwise_count(a ^ b).sum()) / (a.size * 32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def synth(key, n: int, dim: int, step: int = 1 << 17) -> np.ndarray:
    """``(n, dim)`` float32 standard normals drawn on the device from ``key``."""
    import jax

    out = np.empty((n, dim), np.float32)
    for off in range(0, n, step):
        m = min(step, n - off)
        out[off : off + m] = np.asarray(
            jax.random.normal(jax.random.fold_in(key, off), (m, dim), np.float32)
        )
    return out


def plant(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Queries at ~0.8 cosine to the rows of ``x``."""
    noise = rng.standard_normal(x.shape, dtype=np.float32)
    q = 0.8 * x / np.linalg.norm(x, axis=1, keepdims=True)
    q += 0.6 * noise / np.linalg.norm(noise, axis=1, keepdims=True)
    return q.astype(np.float32)


def build(lsh, x: np.ndarray, step: int = 1 << 17) -> float:
    """Index ``x`` under ids ``0..n-1`` through ``LSHRS.index``; seconds."""
    t0 = time.perf_counter()
    for off in range(0, x.shape[0], step):
        lsh.index(np.arange(off, min(off + step, x.shape[0])), x[off : off + step])
    _ = np.asarray(lsh._storage._ids[:1])  # drain the dispatch queue
    return time.perf_counter() - t0


def serve_timed(fn, batches: list) -> tuple:
    """First call (compile + run) seconds, then steady ms per batch."""
    t0 = time.perf_counter()
    first = fn(batches[0])
    compile_s = time.perf_counter() - t0
    times = []
    for b in batches:
        t0 = time.perf_counter()
        fn(b)
        times.append(time.perf_counter() - t0)
    return first, compile_s, 1000 * float(np.median(times))


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(name: str, **fields) -> dict:
    fields = {"phase": name, **fields, "peak_bytes_in_use": peak_bytes()}
    print("phase " + json.dumps(fields), flush=True)
    return fields


def kernel_vs_xla(lsh, rows: np.ndarray, mode: str) -> str | None:
    """Run the store's group-max kernel and the plain XLA formulation on
    the store's own arrays (full width) for ``rows``; they must agree bit
    for bit. Returns the route compared, None when the store runs XLA."""
    import jax.numpy as jnp

    from lshrs_tpu.ops import pallas_scan as ps
    from lshrs_tpu.ops.asymmetric import QMAX, asymmetric_shift, quantize_coords_np
    from lshrs_tpu.ops.hamming import cascade_coarse_scale, unpack_bitplanes

    st = lsh._storage
    st._ensure_ranks()
    c = st._capacity
    group = min(st.group, c)
    qw = lsh._hasher.hash_batch_words(rows)
    if mode == "collision":
        kernel = st._scan_kernel()
        kw = dict(num_bands=st.num_bands, words=st._sig_t.shape[0] // st.num_bands,
                  group=group, scale=ps.key_scale(c))
        run = lambda k: ps.collision_group_max_keys(st._sig_t, st._tie, qw, kernel=k, **kw)
    else:
        st._ensure_planes()
        p = st._planes.shape[1]
        kernel = st._scan_kernel(p)
        tie, kw = st._tie, dict(group=group, chunk=st.chunk, scale=ps.key_scale(c))
        if mode == "asymmetric":
            qb, _ = quantize_coords_np(lsh._hasher.hash_batch_coords_host(rows))
            kw.update(offset=p * QMAX, shift=asymmetric_shift(p, c))
        else:
            qb = unpack_bitplanes(qw, num_bands=st.num_bands,
                                  rows_per_band=st.rows_per_band)[:, :p]
            if mode == "cascade":
                kw["scale"], tshift = cascade_coarse_scale(p, c)
                tie = jnp.where(tie >= 0, tie >> tshift, tie)
        run = lambda k: ps.dot_group_max_keys(st._planes, tie, jnp.asarray(qb), kernel=k, **kw)
    if kernel is None:
        return None
    got, want = np.asarray(run(kernel)), np.asarray(run(None))
    check(np.array_equal(got, want), f"{mode}: {kernel} group maxima differ from XLA")
    return kernel


def _alive(state: dict) -> tuple:
    keep = state["ids"] >= 0
    return state["sig"][keep], state["ids"][keep].astype(np.int64), keep


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_collision(key, rng, *, n: int, dim: int, q: int, n_check: int) -> dict:
    """Collision top-k: exact ``(-count, id)`` order, ties included."""
    from lshrs_tpu import LSHRS

    x = synth(key, n, dim)
    lsh = LSHRS(
        dim=dim, num_perm=NUM_BANDS * ROWS_PER_BAND, num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND, engine="collision",
        initial_capacity=1 << (n - 1).bit_length(),
    )
    build_s = build(lsh, x)
    serve = lsh.serving_fn(TOP_K)
    # Half the batch planted near stored rows, half unrelated.
    batches = [
        np.concatenate([plant(x[rng.integers(0, n, q // 2)], rng),
                        rng.standard_normal((q - q // 2, dim), dtype=np.float32)])
        for _ in range(3)
    ]
    got, compile_s, ms = serve_timed(serve, batches)
    sig, ids, _ = _alive(lsh._storage.state_arrays())
    qwords = np.asarray(lsh._hasher.hash_batch_words(batches[0]))[:n_check]
    want = ref_collision_topk(sig, ids, qwords, num_bands=NUM_BANDS, k=TOP_K)
    mism = int((np.asarray(got)[:n_check] != want).any(axis=1).sum())
    check(mism == 0, f"collision: {mism}/{n_check} queries differ from (-count, id)")
    out = report(
        "collision", n=n, dim=dim, batch=q, build_s=build_s, compile_s=compile_s,
        ms_per_batch=ms, qps=q / ms * 1000, checked=n_check, mismatches=mism,
        scan_kernel=lsh.stats()["index"]["scan_kernel"],
        kernel_vs_xla=kernel_vs_xla(lsh, batches[0][:n_check], "collision"),
    )
    out["_store"] = (lsh, x)
    return out


def phase_hamming(
    key, rng, *, n: int, dim: int, q: int, n_check: int, engine: str = "auto"
) -> dict:
    """Auto -> Hamming top-k, top-p rerank and asymmetric at one capacity."""
    from lshrs_tpu import LSHRS
    from lshrs_tpu.ops.asymmetric import asymmetric_shift, quantize_coords_np

    x = synth(key, n, dim)
    lsh = LSHRS(
        dim=dim, num_perm=NUM_BANDS * ROWS_PER_BAND, num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND, engine=engine, store_vectors=True,
        initial_capacity=1 << (n - 1).bit_length(),
    )
    build_s = build(lsh, x)
    ranking = lsh.stats()["ranking"]
    check(ranking == "hamming", f"engine={engine!r} at {n} rows ranks by {ranking}")
    batches = [plant(x[rng.integers(0, n, q)], rng) for _ in range(3)]
    serve = lsh.serving_fn(TOP_K)
    got, compile_s, ms = serve_timed(serve, batches)
    state = lsh._storage.state_arrays()
    sig, ids, keep = _alive(state)
    qwords = np.asarray(lsh._hasher.hash_batch_words(batches[0]))[:n_check]
    want = ref_hamming_topk(sig, ids, qwords, k=TOP_K)
    ham_mism = int((np.asarray(got)[:n_check] != want).any(axis=1).sum())
    check(ham_mism == 0, f"hamming: {ham_mism}/{n_check} queries differ from (hamming, id)")

    # -- top-p rerank (float64 cosine over the same candidate set) --------
    t0 = time.perf_counter()
    topp = lsh.get_above_p_batch(batches[0], p=TOPP_P)
    topp_s = time.perf_counter() - t0
    ref = ref_topp(
        state["payload"][keep], ids, sig, batches[0][:n_check], qwords,
        num_bands=NUM_BANDS, p=TOPP_P, max_out=4096,
    )
    worst, swaps = 0.0, 0
    for qi, (rid, rcos) in enumerate(ref):
        gid = np.array([i for i, _ in topp[qi]], np.int64)
        gcos = np.array([s for _, s in topp[qi]])
        check(gid.size == rid.size, f"topp query {qi}: {gid.size} results, want {rid.size}")
        if gid.size == 0:
            continue
        worst = max(worst, float(np.abs(gcos - rcos).max()))
        diff = gid != rid
        if diff.any():
            # Only float32 near-ties may trade places: each swapped id's
            # float64 cosine must sit within the tolerance of the rank it took.
            cos_of = dict(zip(rid.tolist(), rcos.tolist()))
            for r in np.flatnonzero(diff):
                c = cos_of.get(int(gid[r]))
                check(c is not None and abs(c - rcos[r]) <= TOPP_TOL,
                      f"topp query {qi} rank {r}: id {gid[r]} is not a near-tie")
            swaps += int(diff.sum())
    check(worst <= TOPP_TOL, f"topp: cosine error {worst} > {TOPP_TOL}")

    # -- asymmetric estimator vs NumPy integer dots ------------------------
    sub = batches[0][:n_check]
    t0 = time.perf_counter()
    asym = lsh.query_asymmetric_batch(sub, top_k=TOP_K)
    asym_s = time.perf_counter() - t0
    qi8, sumabs = quantize_coords_np(lsh._hasher.hash_batch_coords_host(sub))
    planes = unpack_planes(sig, num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND)
    shift = asymmetric_shift(NUM_BANDS * ROWS_PER_BAND, lsh._storage._capacity)
    grain = 1 << shift
    pos = {int(i): j for j, i in enumerate(ids)}
    dots_all = qi8.astype(np.float32) @ planes.T  # exact: see ref_asymmetric_dots
    boundary = 0
    for qi in range(n_check):
        dots = dots_all[qi].astype(np.int64)
        gid = np.array([i for i, _ in asym[qi]], np.int64)
        gdot = np.array([dots[pos[int(i)]] for i in gid])
        denom = max(int(sumabs[qi]), 1)
        # Scores are the integer dots over sum|q|: the refine is exact.
        check(np.array_equal(np.rint(np.array([s for _, s in asym[qi]]) * denom), gdot),
              f"asymmetric query {qi}: scores are not the NumPy integer dots")
        check(np.array_equal(gid, gid[np.lexsort((gid, -gdot))]),
              f"asymmetric query {qi}: not in (dot desc, id asc) order")
        want = _order(-dots, ids, TOP_K)
        if not np.array_equal(gid, want):
            # Selection ranks by dots >> shift (`asymmetric_shift`); only a
            # slot within that grain of the k-th best dot may trade places.
            kth = -np.partition(-dots, TOP_K - 1)[TOP_K - 1]
            moved = np.setxor1d(gid, want)
            check(all(abs(dots[pos[int(i)]] - kth) < grain for i in moved),
                  f"asymmetric query {qi}: differs beyond the 2**{shift} grain")
            boundary += 1
    return report(
        "hamming", n=n, dim=dim, batch=q, ranking=ranking, build_s=build_s,
        compile_s=compile_s, ms_per_batch=ms, qps=q / ms * 1000,
        checked=n_check, hamming_mismatches=ham_mism,
        topp_s=topp_s, topp_max_abs_err=worst, topp_tol=TOPP_TOL,
        topp_near_tie_swaps=swaps, asym_s=asym_s, asym_shift=shift,
        asym_boundary_ties=boundary,
        scan_kernel=lsh.stats()["index"]["scan_kernel"],
        kernel_vs_xla=[kernel_vs_xla(lsh, sub, m) for m in ("hamming", "asymmetric")],
    )


def phase_cascade(key, rng, *, n: int, dim: int, q: int, n_check: int) -> dict:
    """Hamming cascade: planted recall@10 and overlap with exact Hamming."""
    import jax

    from lshrs_tpu import LSHRS

    lsh = LSHRS(
        dim=dim, num_perm=NUM_BANDS * ROWS_PER_BAND, num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND, engine="hamming", hamming_cascade=128,
        hamming_cascade_refine=8192, initial_capacity=1 << (n - 1).bit_length(),
    )
    step = 1 << 19
    src = rng.choice(n, q, replace=False)
    src.sort()
    kept = np.empty((q, dim), np.float32)
    t0 = time.perf_counter()
    for off in range(0, n, step):
        xb = synth(jax.random.fold_in(key, off), min(step, n - off), dim)
        lsh.index(np.arange(off, off + xb.shape[0]), xb)
        inside = (src >= off) & (src < off + xb.shape[0])
        kept[inside] = xb[src[inside] - off]
    _ = np.asarray(lsh._storage._ids[:1])
    build_s = time.perf_counter() - t0
    queries = plant(kept, rng)
    batches = [queries, plant(kept[::-1].copy(), rng), plant(kept, rng)]
    serve = lsh.serving_fn(TOP_K)
    got, compile_s, ms = serve_timed(serve, batches)
    got = np.asarray(got)
    planted = float((got == src[:, None]).any(axis=1).mean())
    check(planted >= PLANTED_RECALL_MIN,
          f"cascade: planted recall@10 {planted} < {PLANTED_RECALL_MIN}")
    sig, ids, _ = _alive(lsh._storage.state_arrays())
    qwords = np.asarray(lsh._hasher.hash_batch_words(queries))[:n_check]
    want = ref_hamming_topk(sig, ids, qwords, k=TOP_K)
    overlap = float(np.mean([
        len(set(want[i].tolist()) & set(got[i].tolist())) / TOP_K
        for i in range(n_check)
    ]))
    pool_ms = _approx_max_k_ms(q, n // 64, 8192 // 64)
    return report(
        "cascade", n=n, dim=dim, batch=q, build_s=build_s, compile_s=compile_s,
        ms_per_batch=ms, qps=q / ms * 1000, planted_recall10=planted,
        planted_min=PLANTED_RECALL_MIN, exact_top10_overlap=overlap,
        checked=n_check, approx_max_k_ms=pool_ms,
        scan_kernel=lsh.stats()["index"]["scan_kernel"],
        kernel_vs_xla=kernel_vs_xla(lsh, queries[:n_check], "cascade"),
    )


def _approx_max_k_ms(q: int, ng: int, m: int) -> float:
    """Time of the cascade's pool selection alone (`approx_max_k` over the
    ``(Q, C / group)`` coarse keys), in its own jitted program."""
    import jax
    import jax.numpy as jnp

    from lshrs_tpu.ops.scan import _pool_top_groups

    fn = jax.jit(lambda g: _pool_top_groups(g, m=m))
    g = jax.random.randint(jax.random.PRNGKey(0), (q, ng), 0, 1 << 30, jnp.int32)
    fn(g).block_until_ready()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(g).block_until_ready()
        times.append(time.perf_counter() - t0)
    return 1000 * float(np.median(times))


def phase_hash(key, *, n: int, dim: int, built=None) -> dict:
    """Share of differing signature bits between hash paths."""
    from lshrs_tpu.hash.hasher import LSHHasher

    x = synth(jax_key(key, 3), n, dim)
    shares = {}
    for family in ("gaussian", "structured"):
        h = LSHHasher(num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=dim,
                      seed=42, hash_family=family)
        shares[family] = bit_share(h.hash_batch_words_host(x),
                                   np.asarray(h.hash_batch_words(x)))
    fused = None
    if built is not None:
        # Rows the fused build stored vs the query hash of a batch of
        # another shape (cuBLAS may pick another algorithm per shape).
        lsh, xb = built
        m = min(5000, xb.shape[0])
        stored = lsh._storage.state_arrays()["sig"][:m]
        fused = bit_share(stored, np.asarray(lsh._hasher.hash_batch_words(xb[:m])))
    for name, share in [*shares.items(), ("fused_vs_query", fused)]:
        if share is not None:
            check(share <= HASH_BIT_TOL,
                  f"hash: {name} bit disagreement {share} > {HASH_BIT_TOL}")
    from lshrs_tpu.native.build import load_fwht_library

    return report(
        "hash", n=n, host_vs_device_gaussian=shares["gaussian"],
        host_vs_device_structured=shares["structured"],
        fused_vs_query=fused, tolerance=HASH_BIT_TOL,
        native_fwht=load_fwht_library() is not None,
    )


def jax_key(key, i: int):
    import jax

    return jax.random.fold_in(key, i)


def phase_four_cards(
    key, rng, *, n: int, dim: int, q: int, shards: int, n_check: int
) -> dict:
    """Sharded Hamming store vs the same index on one card, same process."""
    import jax

    from lshrs_tpu import LSHRS

    kw = dict(
        dim=dim, num_perm=NUM_BANDS * ROWS_PER_BAND, num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND, engine="hamming",
        initial_capacity=1 << (n - 1).bit_length(),
    )
    single = LSHRS(**kw)
    sharded = LSHRS(shards=shards, **kw)
    step = min(1 << 19, n)
    # The last block repeats rows of the first, which sit in another
    # shard: their copies tie exactly across shards.
    dup = min(q, step) // 2
    kept = None
    t0 = time.perf_counter()
    for off in range(0, n, step):
        xb = synth(jax.random.fold_in(key, off), min(step, n - off), dim)
        if off == 0:
            kept = xb[:q].copy()
        if off + step >= n:
            xb[-dup:] = kept[:dup]
        for lsh in (single, sharded):
            lsh.index(np.arange(off, off + xb.shape[0]), xb)
    build_s = time.perf_counter() - t0
    arr = sharded._storage._sig_t
    placed = sorted({s.device.id for s in arr.addressable_shards})
    check(len(placed) == shards, f"four-cards: shards placed on devices {placed}")
    used = [
        (d.memory_stats() or {}).get("bytes_in_use") for d in jax.devices()[:shards]
    ]
    check(all(u is None or u > 0 for u in used),
          f"four-cards: bytes in use per card {used}")
    queries = plant(kept, rng)
    s1 = single.serving_fn(TOP_K)
    s4 = sharded.serving_fn(TOP_K)
    g1, c1, ms1 = serve_timed(s1, [queries, queries])
    g4, c4, ms4 = serve_timed(s4, [queries, queries])
    g1, g4 = np.asarray(g1), np.asarray(g4)
    mism = int((g1 != g4).any(axis=1).sum())
    check(mism == 0, f"four-cards: {mism}/{q} queries differ from one card")
    # (hamming, id) order of every returned list, cross-shard ties included.
    sig, ids, _ = _alive(sharded._storage.state_arrays())
    pos = {int(i): j for j, i in enumerate(ids)}
    qwords = np.asarray(sharded._hasher.hash_batch_words(queries))[:n_check]
    s64, q64 = _as_u64(sig), _as_u64(qwords)
    ties = 0
    for qi in range(qwords.shape[0]):
        row = [int(i) for i in g4[qi] if i >= 0]
        ham = [int(np.bitwise_count(s64[pos[i]] ^ q64[qi]).sum()) for i in row]
        check(list(zip(ham, row)) == sorted(zip(ham, row)),
              f"four-cards query {qi}: not in (hamming, id) order")
        ties += len(ham) - len(set(ham))
    return report(
        "four_cards", n=n, dim=dim, batch=q, shards=shards, devices=placed,
        bytes_in_use=used, build_s=build_s, single_ms=ms1, sharded_ms=ms4,
        single_compile_s=c1, sharded_compile_s=c4, mismatches=mism,
        tied_pairs_checked=ties,
        scan_kernel=sharded.stats()["index"]["scan_kernel"],
    )


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded-vs-single comparison on four cards",
    )
    args = ap.parse_args(argv)

    from run_env import card_line, device_record, enable_compile_cache, require_gpu

    devices = require_gpu()
    enable_compile_cache()
    import jax

    key = jax.random.PRNGKey(args.seed)
    rng = np.random.default_rng(args.seed)
    print(f"card: {card_line()}", flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        check(len(devices) >= 4, f"--four-cards needs 4 GPUs, found {len(devices)}")
        phase_four_cards(jax_key(key, 4), rng, n=1 << 22, dim=DIM,
                         q=QUERY_BATCH, shards=4, n_check=N_CHECK)
    else:
        coll = phase_collision(jax_key(key, 0), rng, n=100_000, dim=DIM,
                               q=QUERY_BATCH, n_check=N_CHECK)
        phase_hash(key, n=1 << 16, dim=DIM, built=coll.pop("_store"))
        ham = phase_hamming(jax_key(key, 1), rng, n=1 << 20, dim=DIM,
                            q=QUERY_BATCH, n_check=N_CHECK)
        cas = phase_cascade(jax_key(key, 2), rng, n=1 << 22, dim=DIM,
                            q=QUERY_BATCH, n_check=N_CHECK)
        # Every grouped scan of these phases must have run the GPU kernel.
        routes = [coll["kernel_vs_xla"], *ham["kernel_vs_xla"], cas["kernel_vs_xla"]]
        check(routes == ["triton"] * 4, f"group-max routes {routes}, want triton")
    print(f"total_s {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
