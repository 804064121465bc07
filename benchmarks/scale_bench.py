"""Scale benchmark: 1M-vector index build + query throughput (config #3).

Builds a GloVe-1M-scale index (default 1,048,576 x 256d) by streaming
batches through the full orchestrator path (hash -> buffer -> device
append), optionally via a Parquet file to exercise `create_signatures`,
then measures pipelined query throughput.

Usage:
    python benchmarks/scale_bench.py [--n 1048576] [--dim 256] [--parquet]
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
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--batch", type=int, default=131_072)
    ap.add_argument("--query-batch", type=int, default=8192)
    ap.add_argument("--n-batches", type=int, default=8)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--bucket-cap", type=int, default=128)
    ap.add_argument("--mode", choices=["scan", "bucket", "hamming"], default="scan",
                    help="query engine: full scan or sorted-bucket search")
    ap.add_argument("--parquet", action="store_true",
                    help="stream via a Parquet file (exercises create_signatures)")
    ap.add_argument("--hash-mode", choices=["device", "host"], default="host",
                    help="hash on device (ships raw vectors) or host (ships "
                    "64B packed words; wins when the link is the bottleneck)")
    args = ap.parse_args()

    import jax

    try:  # reuse compiled kernels across runs (first compile is minutes
        # through the remote helper; cached runs start in seconds)
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

    from lshrs_tpu import LSHRS

    rng = np.random.default_rng(0)
    from lshrs_tpu.storage.device import DeviceStore

    def fresh_lsh() -> LSHRS:
        store0 = DeviceStore(
            num_bands=16,
            rows_per_band=args.num_perm // 16,
            dim=args.dim,
            initial_capacity=args.n,
            query_mode=args.mode if args.mode != "hamming" else "scan",
            bucket_cap=args.bucket_cap,
            enable_hamming=args.mode == "hamming",
            dedupe=False,  # streaming build of known-unique ids
        )
        return LSHRS(
            dim=args.dim,
            num_perm=args.num_perm,
            num_bands=16,
            rows_per_band=args.num_perm // 16,
            storage=store0,
            buffer_size=args.batch * 16,
            hash_mode=args.hash_mode,
        )

    lsh = fresh_lsh()
    # direct store handle for the serving fast path
    store = lsh._storage
    hasher = lsh._hasher

    # ---- build ------------------------------------------------------------
    if args.parquet:
        import pyarrow as pa
        import pyarrow.parquet as pq

        path = Path("/tmp/scale_bench.parquet")
        if not path.exists():
            print("writing parquet ...", file=sys.stderr)
            writer = None
            for start in range(0, args.n, args.batch):
                m = min(args.batch, args.n - start)
                vecs = rng.standard_normal((m, args.dim)).astype(np.float32)
                tbl = pa.table({
                    "index": pa.array(range(start, start + m), type=pa.int64()),
                    "vector": pa.FixedSizeListArray.from_arrays(
                        pa.array(vecs.reshape(-1)), args.dim
                    ),
                })
                if writer is None:
                    writer = pq.ParquetWriter(path, tbl.schema)
                writer.write_table(tbl)
            writer.close()
        t0 = time.perf_counter()
        lsh.create_signatures(format="parquet", source=path, batch_size=args.batch)
        build_s = time.perf_counter() - t0
        cold_s = build_s
    else:
        # Pre-generate outside the timed region (standard_normal at this
        # size costs multiple seconds per batch on a 1-core host and is
        # not part of the ingest path being measured). ONE resident copy:
        # the loader slices views of these arrays.
        all_ids = np.arange(args.n, dtype=np.int64)
        all_vecs = np.empty((args.n, args.dim), dtype=np.float32)
        for start in range(0, args.n, args.batch):
            m = min(args.batch, args.n - start)
            all_vecs[start : start + m] = rng.standard_normal(
                (m, args.dim)
            ).astype(np.float32)

        def timed_build(instance: LSHRS) -> float:
            t0 = time.perf_counter()
            instance.create_signatures(
                format="numpy",
                indices=all_ids,
                vectors=all_vecs,
                batch_size=args.batch,
                prefetch=0,  # batches are already in memory
            )
            # completion barrier: a readback ordered after every append
            _ = np.asarray(instance._storage._ids[:8])
            return time.perf_counter() - t0

        # Cold build (includes the first-dispatch compiles of every
        # ingest program — one-time per process) vs warm steady state.
        cold_s = timed_build(lsh)
        lsh.close()
        lsh = fresh_lsh()
        store, hasher = lsh._storage, lsh._hasher
        build_s = timed_build(lsh)
    alive = lsh.stats()["index"]["alive"]
    build_rate = alive / build_s

    # ---- query ------------------------------------------------------------
    # Same three-stage serving pipeline as bench.py: hasher thread ->
    # single-dispatch compiled query -> reader thread.
    from concurrent.futures import ThreadPoolExecutor

    n_batches = args.n_batches
    raw = [
        rng.standard_normal((args.query_batch, args.dim)).astype(np.float32)
        for _ in range(n_batches)
    ]
    # Queries hash through the SAME path as the build (single hash path
    # per instance: bit-for-bit stored/query signature agreement).
    if args.hash_mode == "host":
        hash_fn, wire = hasher.hash_batch_dense_host, "dense"
    else:
        hash_fn, wire = hasher.hash_batch_words, "words"
    if args.mode == "bucket":
        # The bucketed engine is not part of the single-dispatch snapshot
        # closure; drive it through the store's query_mode-aware path.
        if args.hash_mode == "host":
            hash_fn = hasher.hash_batch_words_host

        def serve(qw):
            return store.query_topk_ids(qw, 10)
    else:
        serve = store.snapshot_query_fn(
            10, wire=wire,
            mode="hamming" if args.mode == "hamming" else "collision",
        )
    _ = np.asarray(serve(hash_fn(raw[0])))

    def trial() -> float:
        hp = ThreadPoolExecutor(max_workers=1)
        rp = ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()
        hashed = [hp.submit(hash_fn, q) for q in raw]
        reads = [rp.submit(np.asarray, serve(f.result())) for f in hashed]
        _ = [f.result() for f in reads]
        dt = time.perf_counter() - t0
        hp.shutdown(); rp.shutdown()
        return dt

    elapsed = min(trial() for _ in range(args.trials))
    qps = n_batches * args.query_batch / elapsed

    stats = lsh.stats()["index"]
    print(json.dumps({
        "n_indexed": alive,
        "dim": args.dim,
        "via": "parquet" if args.parquet else "arrays",
        "mode": args.mode,
        "hash_mode": args.hash_mode,
        "build_s": round(build_s, 2),
        "build_vectors_per_s": round(build_rate, 1),
        "build_cold_s": round(cold_s, 2) if not args.parquet else None,
        "query_qps": round(qps, 1),
        "platform": jax.devices()[0].platform,
        "capacity": stats["capacity"],
        "scan_kernel": stats["scan_kernel"],
        "signature_mb": round(stats["signature_bytes"] / 2**20, 1),
    }))


if __name__ == "__main__":
    main()
