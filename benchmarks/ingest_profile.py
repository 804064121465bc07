"""Stage-level profile of the host-streamed ingest path.

Round 3 measured the streamed build at 164-200k vec/s against a 432k/s
uncontended host hash — a ~2x gap with no named owner. This profile
times every stage of `hash_batch_dense_host` + `add_signature_batch`
separately, then measures a CHUNKED single-threaded loop: JAX dispatch
is async, so hashing chunk i+1 on the host should overlap chunk i's
device decode+append with no threads at all (the round-3 thread-overlap
experiment lost 8x to sgemm contention on this 1-core host; async
dispatch costs nothing).

Stages per batch:
    hash      host FWHT/sgemm + dense bitpack      (CPU-bound)
    upload    jnp.asarray(dense wire) onto device  (transport-bound)
    append    add_signature_batch dispatch          (device + host bookkeeping)
    barrier   readback of 8 ids                     (drains the device queue)

Usage: python benchmarks/ingest_profile.py [--n 1048576] [--chunk 131072]
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
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--chunk", type=int, default=1 << 17)
    ap.add_argument("--hash-family", default="structured")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    rng = np.random.default_rng(0)
    hasher = LSHHasher(
        num_bands=16, rows_per_band=16, dim=args.dim, seed=42,
        hash_family=args.hash_family,
    )

    def fresh_store():
        return DeviceStore(
            num_bands=16, rows_per_band=16, dim=args.dim,
            initial_capacity=args.n, dedupe=False,
        )

    n, chunk = args.n, args.chunk
    chunks = [
        rng.standard_normal((chunk, args.dim)).astype(np.float32)
        for _ in range(n // chunk)
    ]
    ids = [np.arange(i * chunk, (i + 1) * chunk) for i in range(n // chunk)]

    # --- warm every jit shape -------------------------------------------
    store = fresh_store()
    w0 = hasher.hash_batch_dense_host(chunks[0])
    store.add_signature_batch(ids[0], w0)
    _ = np.asarray(store._ids[:8])

    # --- stage timings (serial, per chunk, averaged) ---------------------
    store = fresh_store()
    t_hash = t_upload = t_append = 0.0
    t0_all = time.perf_counter()
    for i, (xb, idb) in enumerate(zip(chunks, ids)):
        t0 = time.perf_counter()
        dense = hasher.hash_batch_dense_host(xb)
        t1 = time.perf_counter()
        dense_dev = jnp.asarray(dense)
        dense_dev.block_until_ready()
        t2 = time.perf_counter()
        store.add_signature_batch(idb, dense_dev)
        t3 = time.perf_counter()
        t_hash += t1 - t0
        t_upload += t2 - t1
        t_append += t3 - t2
    tb = time.perf_counter()
    _ = np.asarray(store._ids[:8])
    t_barrier = time.perf_counter() - tb
    serial_s = time.perf_counter() - t0_all

    # --- chunked async loop (the proposed fix: no explicit sync) ---------
    store2 = fresh_store()
    t0 = time.perf_counter()
    for xb, idb in zip(chunks, ids):
        store2.add_signature_batch(idb, hasher.hash_batch_dense_host(xb))
    _ = np.asarray(store2._ids[:8])
    chunked_s = time.perf_counter() - t0

    # --- monolithic (bench.py's round-3 protocol) -------------------------
    store3 = fresh_store()
    X = np.concatenate(chunks)
    all_ids = np.concatenate(ids)
    store3.add_signature_batch(all_ids, hasher.hash_batch_dense_host(X))
    store3.clear()  # warm the big (n,·) shapes before the timed pass
    t0 = time.perf_counter()
    store3.add_signature_batch(all_ids, hasher.hash_batch_dense_host(X))
    _ = np.asarray(store3._ids[:8])
    mono_s = time.perf_counter() - t0

    # --- uncontended host hash ceiling ------------------------------------
    t0 = time.perf_counter()
    for xb in chunks:
        hasher.hash_batch_dense_host(xb)
    hash_only_s = time.perf_counter() - t0

    print(json.dumps({
        "metric": "streamed_ingest_profile",
        "n": n,
        "chunk": chunk,
        "hash_family": args.hash_family,
        "stages_s": {
            "hash": round(t_hash, 2),
            "upload_blocking": round(t_upload, 2),
            "append_dispatch": round(t_append, 2),
            "final_barrier": round(t_barrier, 2),
        },
        "serial_vectors_per_s": round(n / serial_s, 1),
        "chunked_async_vectors_per_s": round(n / chunked_s, 1),
        "monolithic_vectors_per_s": round(n / mono_s, 1),
        "hash_only_vectors_per_s": round(n / hash_only_s, 1),
        "platform": jax.devices()[0].platform,
    }), flush=True)


if __name__ == "__main__":
    main()
