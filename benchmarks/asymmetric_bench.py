"""End-to-end asymmetric-ranking serving throughput (pipelined).

The asymmetric estimator runs the same int8 group-max kernel as bitplane
Hamming, so its device cost matches the measured Hamming rates; what
differs is the wire — the query ships its quantised projection
coordinates (``num_perm`` int8 bytes/query, 8x the 32-byte dense
signature wire). This bench measures what that costs end-to-end with
the standard three-stage pipeline (hasher thread -> one fused dispatch
per batch -> reader thread).

Usage:
    python benchmarks/asymmetric_bench.py [--n 1048576] [--dim 256] \
        [--query-batch 16384] [--trials 5]
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--bands", type=int, default=16)
    ap.add_argument("--query-batch", type=int, default=16384)
    ap.add_argument("--n-batches", type=int, default=6)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--top-k", type=int, default=10)
    args = ap.parse_args()

    import jax

    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.ops.asymmetric import quantize_coords_np
    from lshrs_tpu.storage.device import DeviceStore

    rows = args.num_perm // args.bands
    rng = np.random.default_rng(11)
    hasher = LSHHasher(
        num_bands=args.bands, rows_per_band=rows, dim=args.dim, seed=42
    )
    store = DeviceStore(
        num_bands=args.bands,
        rows_per_band=rows,
        chunk_size=2048,
        initial_capacity=args.n,
        enable_hamming=True,
        dedupe=False,
    )

    X = rng.standard_normal((args.n, args.dim)).astype(np.float32)
    t0 = time.perf_counter()
    store.add_signature_batch(
        np.arange(args.n), hasher.hash_batch_dense_host(X)
    )
    build_s = time.perf_counter() - t0

    def hash_asym(q: np.ndarray) -> np.ndarray:
        qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(q))
        return qi8

    serve = store.snapshot_query_fn(args.top_k, mode="asymmetric")
    raw = [
        rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
        for _ in range(args.n_batches)
    ]
    # warm the program + verify self-match through the same path
    probe = np.asarray(serve(hash_asym(X[: args.query_batch])))
    self_match = float(
        (probe[:, 0] == np.arange(args.query_batch)).mean()
    )

    def trial() -> float:
        hash_pool = ThreadPoolExecutor(max_workers=1)
        read_pool = ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()
        hashed = [hash_pool.submit(hash_asym, q) for q in raw]
        reads = [read_pool.submit(np.asarray, serve(f.result())) for f in hashed]
        out = [f.result() for f in reads]
        dt = time.perf_counter() - t0
        hash_pool.shutdown()
        read_pool.shutdown()
        assert len(out) == args.n_batches
        return dt

    trials = sorted(trial() for _ in range(args.trials))
    nq = args.n_batches * args.query_batch
    print(
        json.dumps(
            {
                "metric": f"asymmetric_qps_{args.n}x{args.dim}d_top{args.top_k}",
                "qps_best": round(nq / trials[0], 1),
                "qps_median": round(nq / trials[len(trials) // 2], 1),
                "self_match_rate": self_match,
                "wire_bytes_per_query": args.num_perm,
                "build_s": round(build_s, 2),
                "query_batch": args.query_batch,
                "pipeline": "hash-thread/dispatch/reader-thread",
            }
        )
    )


if __name__ == "__main__":
    main()
