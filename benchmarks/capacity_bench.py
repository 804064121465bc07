"""QPS vs capacity for the Hamming serving engines — the >=4M-slot story.

This bench measures serving QPS as capacity grows, and how the refinement
cascade (`hamming_cascade`) compares with the exact single-pass engine.

An exhaustive 256-bit bitplane scan at 12.5M slots x 8192 queries is
~2.6e13 int8 MACs per batch. The cascade scans a prefix of the bitplanes
and re-ranks the top `refine` slots per query at full width.

Method: random Gaussian vectors are synthesized ON DEVICE in 512k chunks
and indexed through the fused hash+append program
(`DeviceStore.add_vectors_batch`), so the host->device link never gates the
build and the signature distribution matches real vector-derived bits
(prefix/full-width rank correlation exists through the vector geometry —
uniform random BITS would put every slot at a near-tied distance ~128 and
make any prefix engine look falsely bad). Serving uses
`snapshot_query_fn(mode="hamming", wire="words")` with the same 3-deep
pipelined readback protocol as bench.py. Self-match sanity re-hashes the
first stored vectors (bit-exact with the fused build). Agreement@10
between cascade and exact ranking is measured on a shared 1024-query probe
(every engine at a capacity holds IDENTICAL content — same PRNG keys).

Usage:
    python benchmarks/capacity_bench.py --slots 4194304 8388608 12500000 \
        --engines exact cascade64 [--q 8192] [--trials 3] [--batches 4]

Prints one JSON line per (slots, engine) plus a final summary line.
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

NUM_BANDS, ROWS_PER_BAND = 16, 16  # num_perm = 256, 16 uint32 words/slot
DIM = 768
TOP_K = 10
CHUNK = 1 << 19  # 512k vectors/chunk: 1.5 GB f32 transient


def build_store(n_slots: int, hasher, *, cascade: int, refine: int,
                group: int = 64, seed: int = 7):
    """DeviceStore with n_slots device-hashed random vectors."""
    import jax

    from lshrs_tpu.storage.device import DeviceStore

    store = DeviceStore(
        num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND,
        dim=DIM,
        enable_hamming=True,
        hamming_cascade=cascade,
        hamming_cascade_refine=refine,
        group_size=group,
        initial_capacity=max(1 << 17, int(2 ** np.ceil(np.log2(n_slots)))),
        dedupe=False,
    )
    proj = hasher.device_projection()
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    probe_x = None
    for off in range(0, n_slots, CHUNK):
        n = min(CHUNK, n_slots - off)
        # fold_in(off): identical content for every engine at a capacity
        x = jax.random.normal(
            jax.random.fold_in(key, off), (n, DIM), dtype=np.float32
        )
        if off == 0:
            probe_x = x[:1024]
        store.add_vectors_batch(np.arange(off, off + n), x, proj)
    build_s = time.perf_counter() - t0
    return store, build_s, probe_x


def run_point(n_slots, engine, hasher, q, n_batches, trials, rng, *,
              group=64, dev_batch=None):
    cascade, refine = 0, 2048
    if engine.startswith("cascade"):
        spec = engine[len("cascade"):]
        if ":" in spec:
            bits, refine = spec.split(":")
            cascade, refine = int(bits), int(refine)
        else:
            cascade = int(spec)
    store, build_s, probe_x = build_store(
        n_slots, hasher, cascade=cascade, refine=refine, group=group
    )

    # The exact engine past the grouped int32 key ceiling (capacity ~8M at
    # num_perm=256) falls back to the chunked scan, whose per-chunk top-k
    # pools stack (nchunks, Q, k) — at Q=8192 that alone is tens of GB, so
    # split the batch inside the program.
    if dev_batch is None and not cascade and store._capacity >= (1 << 23):
        dev_batch = 1024
    serve = store.snapshot_query_fn(
        TOP_K, mode="hamming", wire="words", dev_batch=dev_batch
    )

    # self-match: re-hashed stored vectors at Hamming 0 return their own id
    self_words = np.asarray(hasher.hash_batch_words(probe_x))
    got = np.asarray(serve(self_words))
    self_match = float((got[:, 0] == np.arange(1024)).mean())

    # Planted-neighbor probe: perturb the first 1024 stored vectors to a
    # ~0.8 target cosine. These queries have GENUINE near neighbors — the
    # regime the engine exists for. (Uniformly random probes at 768d have
    # top-10 sets that are noise-level ties even for the exact engine;
    # agreement on them measures tie ordering, not retrieval quality.)
    px = np.asarray(probe_x)
    noise = probe_rng_noise(px.shape)
    probe_q = 0.8 * px / np.linalg.norm(px, axis=1, keepdims=True) + 0.6 * (
        noise / np.linalg.norm(noise, axis=1, keepdims=True)
    )
    probe_words = np.asarray(
        hasher.hash_batch_words(probe_q.astype(np.float32)), dtype=np.uint32
    )
    probe_ids = np.asarray(serve(probe_words))
    planted = float((probe_ids == np.arange(1024)[:, None]).any(axis=1).mean())

    raw = [
        np.asarray(
            hasher.hash_batch_words(
                rng.standard_normal((q, DIM)).astype(np.float32)
            ),
            dtype=np.uint32,
        )
        for _ in range(n_batches)
    ]
    _ = np.asarray(serve(raw[0]))  # warm the serving shape

    def timed_trial() -> float:
        pool = ThreadPoolExecutor(max_workers=3)
        t0 = time.perf_counter()
        futs = [pool.submit(serve, b) for b in raw]
        out = [np.asarray(f.result()) for f in futs]
        dt = time.perf_counter() - t0
        pool.shutdown()
        assert len(out) == n_batches
        return dt

    ts = sorted(timed_trial() for _ in range(trials))
    n_q = q * n_batches
    row = {
        "slots": n_slots,
        "engine": engine,
        "group": group,
        "dev_batch": dev_batch,
        "capacity": store._capacity,
        "qps": round(n_q / ts[0], 1),
        "qps_median": round(n_q / ts[len(ts) // 2], 1),
        "ms_per_batch": round(1000 * ts[0] / n_batches, 1),
        "self_match": self_match,
        "planted_recall_at_10": planted,
        "build_s": round(build_s, 1),
        "plane_bytes": store.stats()["hamming_plane_bytes"],
    }
    del store, serve
    return row, probe_ids


def probe_rng_noise(shape):
    return np.random.default_rng(999).standard_normal(shape).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, nargs="+",
                    default=[1 << 22, 1 << 23, 12_500_000])
    ap.add_argument("--engines", nargs="+",
                    default=["exact", "cascade128:8192"])
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--dev-batch", type=int, default=None)
    args = ap.parse_args()

    import jax

    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

    from lshrs_tpu.hash.hasher import LSHHasher

    hasher = LSHHasher(
        num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM, seed=42
    )
    rng = np.random.default_rng(123)

    rows = []
    for n_slots in args.slots:
        ids_by_engine = {}
        for engine in args.engines:
            row, probe_ids = run_point(
                n_slots, engine, hasher, args.q, args.batches, args.trials,
                rng, group=args.group, dev_batch=args.dev_batch,
            )
            ids_by_engine[engine] = probe_ids
            if "exact" in ids_by_engine and engine != "exact":
                ref = ids_by_engine["exact"]
                row["agreement_at_10_vs_exact"] = round(float(np.mean([
                    len(set(ref[i]) & set(probe_ids[i])) / TOP_K
                    for i in range(ref.shape[0])
                ])), 4)
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"summary": rows}), flush=True)


if __name__ == "__main__":
    main()
