"""Gather vs full rerank engine: device cost vs capacity.

Shows the point of the candidate-gather engine: the full formulation's
``(Q, C)`` cosine matmul scales with CAPACITY, the gather formulation's
cost scales with the CANDIDATE budget. Data is generated and hashed on
device (`DeviceStore.add_vectors_batch`), so the bench builds 1M x 768d
with a resident payload in seconds and no multi-GB uploads; queries are
hashed on device from a pre-uploaded batch, and device latency is
measured by queueing K dispatches and syncing once (transport excluded —
this is the kernel-cost comparison, the pipelined end-to-end number is
`rerank_bench.py`).

Usage: python benchmarks/gather_rerank_bench.py [--caps 131072,1048576]
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
    ap.add_argument("--caps", default="131072,1048576",
                    help="comma-separated store sizes to sweep")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--query-batch", type=int, default=1024)
    ap.add_argument("--max-candidates", type=int, default=1024)
    ap.add_argument("--dispatches", type=int, default=8)
    ap.add_argument("--payload-dtype", choices=["float32", "bfloat16", "int8"],
                    default="float32")
    ap.add_argument("--engines", default="full,gather",
                    help="comma list; past ~2M slots the full engine cannot "
                    "even compile at Q=1024 (its (Q, C) counts + sims "
                    "temporaries alone are 8 bytes per query and slot) — run "
                    "'--engines gather' there")
    args = ap.parse_args()

    import jax

    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass
    import jax.numpy as jnp

    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    b, r = 16, args.num_perm // 16
    hasher = LSHHasher(num_bands=b, rows_per_band=r, dim=args.dim, seed=42)
    proj = hasher.device_projection()
    key = jax.random.PRNGKey(0)

    results = []
    for cap_s in args.caps.split(","):
        n = int(cap_s)
        store = DeviceStore(
            num_bands=b, rows_per_band=r, dim=args.dim, store_vectors=True,
            initial_capacity=n, dedupe=False, chunk_size=2048,
            payload_dtype=args.payload_dtype,
        )
        # device-generated data, fused device build (no host round trips)
        step = 1 << 18
        for off in range(0, n, step):
            m = min(step, n - off)
            xb = jax.random.normal(
                jax.random.fold_in(key, off), (m, args.dim), jnp.float32
            )
            store.add_vectors_batch(np.arange(off, off + m), xb, proj)
        assert len(store) == n

        qx = jax.random.normal(jax.random.PRNGKey(7), (args.query_batch, args.dim))
        qw = hasher.hash_batch_words(qx)  # device hash: matches stored bits
        qw.block_until_ready()

        row = {"n": n}
        for engine in args.engines.split(","):
            serve = store.snapshot_topp_fn(
                10, wire="words", engine=engine,
                max_candidates=args.max_candidates,
            )
            out = serve(qw, qx)
            ids0 = np.asarray(out[0])
            # self-match sanity on the first 64 queries? queries are fresh
            # random draws; instead check result validity + candidate counts
            nvals = np.asarray(out[2])
            t0 = time.perf_counter()
            for _ in range(args.dispatches):
                out = serve(qw, qx)
            _ = [np.asarray(x[:1]) for x in out]  # one sync for the queue
            dt = (time.perf_counter() - t0) / args.dispatches
            row[f"{engine}_ms_per_batch"] = round(dt * 1e3, 2)
            row[f"{engine}_qps_device"] = round(args.query_batch / dt, 1)
            if engine == "gather":
                row["mean_candidates"] = round(float(nvals.mean()), 1)
                row["truncated_frac"] = round(
                    float((nvals >= args.max_candidates).mean()), 4
                )
            del serve, out, ids0
        if "full_ms_per_batch" in row and "gather_ms_per_batch" in row:
            row["speedup"] = round(
                row["full_ms_per_batch"] / row["gather_ms_per_batch"], 2
            )
        results.append(row)
        store.close()
        print(json.dumps({"metric": "gather_vs_full_rerank", **row}), flush=True)

    print(json.dumps({
        "metric": "gather_rerank_sweep_summary",
        "dim": args.dim,
        "num_perm": args.num_perm,
        "query_batch": args.query_batch,
        "max_candidates": args.max_candidates,
        "payload_dtype": args.payload_dtype,
        "platform": jax.devices()[0].platform,
        "rows": results,
    }))


if __name__ == "__main__":
    main()
