"""Top-p rerank benchmark: fused batched get_above_p.

Measures batched cosine-reranked top-p throughput against the resident
payload matrix: one device dispatch per batch computes collision counts,
cosine similarities (one matmul) and the exact (cosine desc, id asc)
ordering; the host applies the reference's max(1, ceil(p * n)) cutoff.

Usage: python benchmarks/rerank_bench.py [--n 100000] [--dim 768] [--p 0.2]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--p", type=float, default=0.2)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--query-batch", type=int, default=1024)
    ap.add_argument("--n-batches", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--wire-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="query upload dtype (bfloat16 halves the bytes)")
    args = ap.parse_args()

    import jax

    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

    from lshrs_tpu import LSHRS

    rng = np.random.default_rng(0)
    lsh = LSHRS(
        dim=args.dim,
        num_perm=args.num_perm,
        num_bands=16,
        rows_per_band=args.num_perm // 16,
        backend="device",
        store_vectors=True,
        initial_capacity=1 << max(14, (args.n - 1).bit_length()),
        dedupe=False,
    )
    X = rng.standard_normal((args.n, args.dim)).astype(np.float32)
    lsh.index(np.arange(args.n), X)

    raw = [
        rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
        for _ in range(args.n_batches)
    ]
    # warm compile + correctness probe: self-queries rerank themselves first
    probe = lsh.get_above_p_batch(
        X[: args.query_batch], p=args.p, top_k=args.top_k,
        wire_dtype=args.wire_dtype,
    )
    self_match = float(
        np.mean([r[0][0] == i for i, r in enumerate(probe) if r])
    )

    # Pipelined serving loop (the top-k bench's architecture): a hasher
    # thread produces (dense wire, bf16/f32 query) pairs, the main thread
    # dispatches the fused snapshot closure, a reader thread drains
    # results — upload, device compute and readback overlap.
    from concurrent.futures import ThreadPoolExecutor

    import ml_dtypes

    store = lsh._storage
    hasher = lsh._hasher
    serve = store.snapshot_topp_fn(args.top_k, wire="dense")
    qdt = ml_dtypes.bfloat16 if args.wire_dtype == "bfloat16" else np.float32

    def prep(q):
        return hasher.hash_batch_dense_host(q), q.astype(qdt)

    _ = [np.asarray(x) for x in serve(*prep(raw[0]))]  # warm compile

    def trial() -> float:
        hash_pool = ThreadPoolExecutor(max_workers=1)
        read_pool = ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()
        hashed = [hash_pool.submit(prep, q) for q in raw]
        reads = [
            read_pool.submit(
                lambda out: tuple(np.asarray(x) for x in out),
                serve(*f.result()),
            )
            for f in hashed
        ]
        results = [f.result() for f in reads]
        elapsed = time.perf_counter() - t0
        hash_pool.shutdown()
        read_pool.shutdown()
        assert len(results) == args.n_batches
        return elapsed

    elapsed = min(trial() for _ in range(args.trials))
    n_q = args.n_batches * args.query_batch
    print(
        json.dumps(
            {
                "metric": "rerank_topp_qps_pipelined",
                "wire_dtype": args.wire_dtype,
                "n": args.n,
                "dim": args.dim,
                "p": args.p,
                "top_k": args.top_k,
                "query_batch": args.query_batch,
                "qps": round(n_q / elapsed, 1),
                "latency_ms_per_batch": round(1000 * elapsed / args.n_batches, 2),
                "self_match_rate": self_match,
                "platform": jax.devices()[0].platform,
            }
        )
    )


if __name__ == "__main__":
    main()
