"""Serving and build benchmark of the device store on one GPU.

    python bench.py

Rows (one process, one card):

- 100k x 768d, 256-bit banded LSH, collision top-10: raw float32 query
  batches are hashed on the host with the structured (FWHT) family (the
  native C kernel, `lshrs_tpu/native/fwht.c`) into the 32-byte dense wire
  signature, served by ONE fused device dispatch per batch
  (`DeviceStore.snapshot_query_fn`: wire decode + group-max scan + exact
  (count, id) top-10), and the ids are read back. A hasher thread, the
  dispatching main thread and a reader thread overlap as a serving loop
  does.
- builds: the fused device build (hash + append in one program,
  `DeviceStore.add_vectors_batch`) and the host-streamed dense-wire build.
- 1M x 768d through ``LSHRS`` (auto engine -> Hamming past 512k slots),
  with planted and exact recall@10.
- 4M x 768d Hamming cascade (128-bit prefix, 8192-slot refine pool) on
  pre-hashed ``words`` queries, with planted recall@10.

Prints exactly one JSON line with the device (platform, kind, count and
the card's name and power limit from nvidia-smi). Exits 2 when JAX finds
no GPU; any failed row fails the run.
"""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_VECTORS = 100_000
DIM = 768
NUM_BANDS, ROWS_PER_BAND = 16, 16  # num_perm = 256
TOP_K = 10
QUERY_BATCH = 16384
N_TRIALS = 5


def main() -> None:
    from run_env import card_line, device_record, enable_compile_cache, require_gpu

    devices = require_gpu()
    enable_compile_cache()
    import jax

    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    rng = np.random.default_rng(0)

    # Serving + host-streamed-build hasher: the structured (FWHT) family,
    # whose native C path is the fast host hash. The device-resident fused
    # build keeps the gaussian family (one dense matmul on the device).
    # Each store uses ONE family end-to-end.
    hasher = LSHHasher(
        num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM, seed=42,
        hash_family="structured",
    )
    dev_hasher = LSHHasher(
        num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM, seed=42
    )
    store = DeviceStore(
        num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND,
        dim=DIM,
        chunk_size=2048,
        initial_capacity=1 << 17,
        dedupe=False,  # streaming build of known-unique ids, fully on device
    )

    # ---- build ------------------------------------------------------------
    # 1. DEVICE-RESIDENT build: vectors already in device memory (where
    #    embeddings produced on the same card live) hashed AND appended by
    #    ONE fused device program (`DeviceStore.add_vectors_batch`).
    #    Self-match is checked with device-hashed queries.
    # 2. HOST-STREAMED build: host hash + 32-byte dense wire, end to end
    #    over the host->device link.
    #
    # The serving (QPS) store uses the host hash path end-to-end so the
    # 32-byte query wire self-matches.
    X = rng.standard_normal((N_VECTORS, DIM)).astype(np.float32)
    ids = np.arange(N_VECTORS)

    import jax.numpy as jnp

    dev_store = DeviceStore(
        num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND,
        dim=DIM,
        chunk_size=2048,
        initial_capacity=1 << 17,
        dedupe=False,
    )
    X_dev = jnp.asarray(X)  # one-time upload, untimed (production: born here)
    proj = dev_hasher.device_projection()
    dev_store.add_vectors_batch(ids, X_dev, proj)  # warm the fused jit

    def timed_device_build() -> float:
        dev_store.clear()
        t0 = time.perf_counter()
        dev_store.add_vectors_batch(ids, X_dev, proj)  # ONE device program
        _ = np.asarray(dev_store._ids[:8])  # ordered completion barrier
        return time.perf_counter() - t0

    dev_trials = sorted(timed_device_build() for _ in range(5))
    dev_build_rate = N_VECTORS / dev_trials[0]
    dev_build_median = N_VECTORS / dev_trials[len(dev_trials) // 2]
    # fused-built rows must self-match device-hashed queries bit-for-bit
    dq = dev_hasher.hash_batch_words(X_dev[:2048])
    _, dev_ids = dev_store.query_topk(dq, 1)
    dev_self_match = float((dev_ids[:, 0] == ids[:2048]).mean())

    # warm up the host hash/append jits on an equally-sized batch first
    store.add_signature_batch(ids, hasher.hash_batch_dense_host(X))
    store.clear()

    def timed_stream_build() -> float:
        store.clear()
        t0 = time.perf_counter()
        dense = hasher.hash_batch_dense_host(X)  # host sgemm + dense bitpack
        store.add_signature_batch(ids, dense)  # 32 B/vector wire, device decode
        _ = np.asarray(store._ids[:8])  # ordered completion barrier
        return time.perf_counter() - t0

    stream_trials = sorted(timed_stream_build() for _ in range(3))
    stream_build_rate = N_VECTORS / stream_trials[0]
    stream_build_median = N_VECTORS / stream_trials[len(stream_trials) // 2]

    # ---- query ------------------------------------------------------------
    # Serving architecture: clients (here, a hasher thread) hash raw query
    # vectors to the 32-byte dense wire signature; the main thread ships
    # signatures and dispatches ONE fused device program per batch (wire
    # decode + collision group-max scan + exact (count, id) top-10 + id
    # select); a reader thread drains the (Q, 10) id results. All three
    # stages overlap.
    n_batches = 6
    raw_batches = [
        rng.standard_normal((QUERY_BATCH, DIM)).astype(np.float32)
        for _ in range(n_batches)
    ]
    serve = store.snapshot_query_fn(TOP_K, wire="dense")

    # warmup / compile
    _ = np.asarray(serve(hasher.hash_batch_dense_host(raw_batches[0])))

    def timed_trial() -> float:
        hash_pool = ThreadPoolExecutor(max_workers=1)
        read_pool = ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()
        hashed = [
            hash_pool.submit(hasher.hash_batch_dense_host, q) for q in raw_batches
        ]
        reads = [read_pool.submit(np.asarray, serve(f.result())) for f in hashed]
        results = [f.result() for f in reads]
        elapsed = time.perf_counter() - t0
        hash_pool.shutdown()
        read_pool.shutdown()
        assert len(results) == n_batches
        return elapsed

    # Best and median of five steady-state trials.
    trials = sorted(timed_trial() for _ in range(N_TRIALS))
    elapsed = trials[0]
    n_queries = n_batches * QUERY_BATCH
    qps = n_queries / elapsed
    qps_median = n_queries / trials[len(trials) // 2]

    # sanity: self-queries must find themselves (exact self-match, 16 bands)
    probe = np.asarray(serve(hasher.hash_batch_dense_host(X[:QUERY_BATCH])))
    self_match = float((probe[:, 0] == np.arange(QUERY_BATCH)).mean())

    # ---- 1M default construction -----------------------------------------
    # LSHRS(dim=768, num_perm=256, engine="auto") with 1,048,576 vectors
    # served through serving_fn() — the auto engine ranks by Hamming past
    # 512k slots. hash_mode="host" ships the 32-byte query wire. 3 trials
    # x 4 batches of 8192.
    #
    # Build: data is synthesized off the timed loop in float32, and the
    # loop is plain `lsh.index()` calls of 65,536 rows — JAX's async
    # dispatch overlaps chunk i's device decode+append with chunk i+1's
    # host hash. The final device-queue drain is a tiny readback barrier.
    from lshrs_tpu import LSHRS

    n_1m = 1 << 20
    lsh = LSHRS(
        dim=DIM,
        num_perm=NUM_BANDS * ROWS_PER_BAND,
        num_bands=NUM_BANDS,
        rows_per_band=ROWS_PER_BAND,
        hash_mode="host",
        hash_family="structured",
        initial_capacity=n_1m,
        dedupe=False,
        buffer_size=1 << 30,
    )
    step, q_1m = 1 << 16, 8192
    # Clustered base data (Gaussian-mixture, like real embedding
    # spaces): on UNIFORM Gaussian data at 768d every non-planted
    # "true neighbour" of a probe sits at noise-level cosine (~0.19)
    # below any 256-bit estimator's distance resolution, so recall@10
    # there measures tie ordering, not retrieval. Engine cost is
    # data-independent (fixed-shape scans), so QPS is unaffected.
    centers_1m = rng.standard_normal((4096, DIM)).astype(np.float32)
    chunks_1m = [
        centers_1m[rng.integers(0, 4096, step)]
        + 0.35 * rng.standard_normal((step, DIM), dtype=np.float32)
        for _ in range(n_1m // step)
    ]
    ids_1m = [
        np.arange(off, off + step) for off in range(0, n_1m, step)
    ]
    X_keep = chunks_1m[0][:q_1m].copy()
    lsh.index(ids_1m[0], chunks_1m[0])  # warm the per-chunk jit shapes
    lsh.clear()
    t0 = time.perf_counter()
    for idb, xb in zip(ids_1m, chunks_1m):
        lsh.index(idb, xb)
    _ = np.asarray(lsh._storage._ids[:8])  # drain the dispatch queue
    build_1m_s = time.perf_counter() - t0
    assert lsh.stats()["index"]["alive"] == n_1m

    serve_1m = lsh.serving_fn(top_k=TOP_K)
    probe_1m = np.asarray(serve_1m(X_keep))  # compile + self-match
    self_match_1m = float((probe_1m[:, 0] == np.arange(q_1m)).mean())

    # Recall@10 of the exact configuration served here (auto->Hamming,
    # structured family, host hash): 512 planted-near-neighbor queries
    # (~0.8 cosine to a stored vector — uniformly random probes at 768d
    # have noise-tied top-10s that measure tie ordering, not retrieval),
    # ground truth = exact cosine top-10 over all 1M rows (host BLAS,
    # untimed).
    n_probe = 512
    px = chunks_1m[0][:n_probe]
    noise = np.random.default_rng(999).standard_normal(
        px.shape, dtype=np.float32
    )
    probe_q = 0.8 * px / np.linalg.norm(px, axis=1, keepdims=True)
    probe_q += 0.6 * noise / np.linalg.norm(noise, axis=1, keepdims=True)
    probe_q = probe_q.astype(np.float32)
    qn = probe_q / np.linalg.norm(probe_q, axis=1, keepdims=True)
    best_s = np.full((n_probe, 0), 0.0, np.float32)
    best_i = np.full((n_probe, 0), -1, np.int64)
    for idb, xb in zip(ids_1m, chunks_1m):
        s = (qn @ xb.T) / np.linalg.norm(xb, axis=1)[None, :]
        part = np.argpartition(-s, TOP_K - 1, axis=1)[:, :TOP_K]
        best_s = np.concatenate(
            [best_s, np.take_along_axis(s, part, axis=1)], axis=1
        )
        best_i = np.concatenate([best_i, idb[part]], axis=1)
        keep = np.argpartition(-best_s, TOP_K - 1, axis=1)[:, :TOP_K]
        best_s = np.take_along_axis(best_s, keep, axis=1)
        best_i = np.take_along_axis(best_i, keep, axis=1)
    got_1m = np.asarray(serve_1m(probe_q))[:, :TOP_K]
    recall10_1m = float(np.mean([
        len(set(best_i[i].tolist()) & set(got_1m[i].tolist())) / TOP_K
        for i in range(n_probe)
    ]))
    planted_1m = float(
        (got_1m == np.arange(n_probe)[:, None]).any(axis=1).mean()
    )
    raw_1m = [
        rng.standard_normal((q_1m, DIM)).astype(np.float32)
        for _ in range(4)
    ]

    def timed_1m_trial() -> float:
        pool = ThreadPoolExecutor(max_workers=3)
        t0 = time.perf_counter()
        futs = [pool.submit(serve_1m, q) for q in raw_1m]
        out = [np.asarray(f.result()) for f in futs]
        dt = time.perf_counter() - t0
        pool.shutdown()
        assert len(out) == len(raw_1m)
        return dt

    trials_1m = sorted(timed_1m_trial() for _ in range(3))
    n_q_1m = len(raw_1m) * q_1m
    one_m = {
        "qps_1m": round(n_q_1m / trials_1m[0], 1),
        "qps_1m_median": round(n_q_1m / trials_1m[len(trials_1m) // 2], 1),
        "self_match_rate_1m": self_match_1m,
        "recall10_1m": round(recall10_1m, 4),
        "planted_recall_1m": round(planted_1m, 4),
        "ranking_1m": lsh.stats()["ranking"],
        "build_1m_s": round(build_1m_s, 1),
        "build_1m_vectors_per_s": round(n_1m / build_1m_s, 1),
    }
    del lsh, serve_1m, chunks_1m

    # ---- 4M cascade serving row (the >=4M-slot engine) --------------------
    # Serving runs the Hamming refinement cascade with a 128-bit coarse
    # prefix and an exact full-width refine of 8192 slots/query (a 64-bit
    # prefix is too coarse). Vectors are synthesized on the device and
    # built by the fused hash+append program; the planted probe perturbs
    # stored vectors to ~0.8 cosine — queries with genuine near
    # neighbours, the regime the engine exists for.
    from lshrs_tpu.storage.device import DeviceStore as _DS

    n_4m, q_4m = 1 << 22, 8192
    cas = _DS(
        num_bands=NUM_BANDS, rows_per_band=ROWS_PER_BAND, dim=DIM,
        enable_hamming=True, hamming_cascade=128,
        hamming_cascade_refine=8192,
        initial_capacity=n_4m, dedupe=False,
    )
    proj_4m = dev_hasher.device_projection()
    key = jax.random.PRNGKey(7)
    synth = 1 << 19
    t0 = time.perf_counter()
    probe_x = None
    for off in range(0, n_4m, synth):
        xdev = jax.random.normal(
            jax.random.fold_in(key, off), (synth, DIM), dtype=np.float32
        )
        if off == 0:
            probe_x = xdev[:1024]
        cas.add_vectors_batch(np.arange(off, off + synth), xdev, proj_4m)
    _ = np.asarray(cas._ids[:8])
    build_4m_s = time.perf_counter() - t0

    serve_4m = cas.snapshot_query_fn(TOP_K, mode="hamming", wire="words")
    self_w = np.asarray(dev_hasher.hash_batch_words(probe_x))
    got = np.asarray(serve_4m(self_w))
    self_match_4m = float((got[:, 0] == np.arange(1024)).mean())
    px = np.asarray(probe_x)
    pn = np.random.default_rng(999).standard_normal(
        px.shape
    ).astype(np.float32)
    pq = 0.8 * px / np.linalg.norm(px, axis=1, keepdims=True) + 0.6 * (
        pn / np.linalg.norm(pn, axis=1, keepdims=True)
    )
    pw = np.asarray(
        dev_hasher.hash_batch_words(pq.astype(np.float32)),
        dtype=np.uint32,
    )
    planted_4m = float(
        (np.asarray(serve_4m(pw)) == np.arange(1024)[:, None])
        .any(axis=1).mean()
    )

    raw_4m = [
        np.asarray(
            dev_hasher.hash_batch_words(
                rng.standard_normal((q_4m, DIM)).astype(np.float32)
            ),
            dtype=np.uint32,
        )
        for _ in range(4)
    ]
    _ = np.asarray(serve_4m(raw_4m[0]))  # warm the serving shape

    def timed_4m_trial() -> float:
        pool = ThreadPoolExecutor(max_workers=3)
        t0 = time.perf_counter()
        futs = [pool.submit(serve_4m, b) for b in raw_4m]
        got = [np.asarray(f.result()) for f in futs]
        dt = time.perf_counter() - t0
        pool.shutdown()
        assert len(got) == len(raw_4m)
        return dt

    trials_4m = sorted(timed_4m_trial() for _ in range(3))
    n_q_4m = len(raw_4m) * q_4m
    four_m = {
        "qps_4m": round(n_q_4m / trials_4m[0], 1),
        "qps_4m_median": round(n_q_4m / trials_4m[len(trials_4m) // 2], 1),
        "self_match_rate_4m": self_match_4m,
        "planted_recall_4m": planted_4m,
        "cascade_4m": "cascade128:8192",
        "build_4m_s": round(build_4m_s, 1),
    }
    del cas, serve_4m

    result = {
        "metric": "query_qps_100k_d768_p256_top10",
        "value": round(qps, 1),
        "unit": "qps",
        "device": {**device_record(devices), "card": card_line()},
        "extras": {
            "fast_path": store.stats()["fast_path"],
            "scan_kernel": store.stats()["scan_kernel"],
            # device-resident fused build (hash+append, one program)
            "build_vectors_per_s": round(dev_build_rate, 1),
            "build_vectors_per_s_median": round(dev_build_median, 1),
            "build_self_match_rate": dev_self_match,
            # host-streamed build (sgemm + 32B dense wire, end-to-end)
            "build_stream_vectors_per_s": round(stream_build_rate, 1),
            "build_stream_vectors_per_s_median": round(stream_build_median, 1),
            "qps_median": round(qps_median, 1),
            "query_batch": QUERY_BATCH,
            "serving_hash_family": "structured",
            "pipeline": "hash-thread/dispatch/reader-thread",
            "latency_ms_per_batch": round(
                1000 * elapsed / (n_queries / QUERY_BATCH), 3
            ),
            "self_match_rate": self_match,
            "n_vectors": N_VECTORS,
            **one_m,
            **four_m,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
