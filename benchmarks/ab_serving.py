"""Interleaved A/B: flat ``lax.top_k`` selection vs ``topk_wide``.

Commit 2492110 rewired the grouped collision tail and the hierarchical
group selection leaves from flat ``lax.top_k`` onto the blockwise
``topk_wide`` selector (a win at 4M+ columns, untested at 100k scale).

This bench compares them: BOTH selection variants compiled against the
SAME store in ONE process on ONE card, trials interleaved (A B A B ...) so
drift hits both equally.
Variant A monkeypatches ``lshrs_tpu.ops.scan.topk_wide`` back to a flat
``lax.top_k`` wrapper before tracing its serving closure — exactly the
round-3 selection (`git show 2492110 -- lshrs_tpu/ops/scan.py`: the only
call-site changes were lax.top_k -> topk_wide); variant B is the current
code. Everything else (store content, hasher, wire, pipeline, batches)
is shared.

Usage: python benchmarks/ab_serving.py [--n 100000] [--q 16384]
       [--trials 5] [--batches 6]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NUM_BANDS, ROWS_PER_BAND, DIM, TOP_K = 16, 16, 768, 10


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=16384)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--batches", type=int, default=6)
    args = ap.parse_args()

    import jax

    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

    import lshrs_tpu.ops.scan as scan_mod
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    hasher = LSHHasher(
        num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM, seed=42,
        hash_family="structured",
    )
    store = DeviceStore(
        num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM,
        chunk_size=2048, initial_capacity=1 << 17, dedupe=False,
    )
    rng = np.random.default_rng(0)
    X = rng.standard_normal((args.n, DIM)).astype(np.float32)
    store.add_signature_batch(np.arange(args.n), hasher.hash_batch_dense_host(X))

    raw = [
        rng.standard_normal((args.q, DIM)).astype(np.float32)
        for _ in range(args.batches)
    ]
    wires = [hasher.hash_batch_dense_host(b) for b in raw]

    # --- variant A: round-3 flat lax.top_k selection ----------------------
    real_topk_wide = scan_mod.topk_wide

    def flat_topk_wide(key, m, **_):
        v, p = jax.lax.top_k(key, min(m, key.shape[1]))
        return v, p.astype(np.int32)

    scan_mod.topk_wide = flat_topk_wide
    try:
        serve_a = store.snapshot_query_fn(TOP_K, wire="dense")
        warm_a = np.asarray(serve_a(wires[0]))  # trace under the patch
    finally:
        scan_mod.topk_wide = real_topk_wide

    # --- variant B: current (round-4/5) blockwise topk_wide ---------------
    serve_b = store.snapshot_query_fn(TOP_K, wire="dense")
    warm_b = np.asarray(serve_b(wires[0]))
    assert np.array_equal(warm_a, warm_b), "selection variants disagree"

    def timed_trial(serve) -> float:
        hash_pool = ThreadPoolExecutor(max_workers=1)
        read_pool = ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()
        hashed = [
            hash_pool.submit(hasher.hash_batch_dense_host, b) for b in raw
        ]
        reads = [read_pool.submit(np.asarray, serve(f.result())) for f in hashed]
        out = [f.result() for f in reads]
        dt = time.perf_counter() - t0
        hash_pool.shutdown()
        read_pool.shutdown()
        assert len(out) == args.batches
        return dt

    n_q = args.q * args.batches
    t_a, t_b = [], []
    for _ in range(args.trials):  # strict interleave: drift hits both
        t_a.append(timed_trial(serve_a))
        t_b.append(timed_trial(serve_b))
    t_a.sort()
    t_b.sort()
    out = {
        "metric": "ab_flat_topk_vs_topk_wide_100k",
        "n": args.n,
        "q_batch": args.q,
        "trials": args.trials,
        "flat_qps_best": round(n_q / t_a[0], 1),
        "flat_qps_median": round(n_q / t_a[len(t_a) // 2], 1),
        "wide_qps_best": round(n_q / t_b[0], 1),
        "wide_qps_median": round(n_q / t_b[len(t_b) // 2], 1),
        "wide_over_flat_best": round(t_a[0] / t_b[0], 4),
        "wide_over_flat_median": round(
            t_a[len(t_a) // 2] / t_b[len(t_b) // 2], 4
        ),
        "platform": jax.devices()[0].platform,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
