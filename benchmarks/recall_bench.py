"""Recall benchmark: LSH retrieval quality vs exact cosine ground truth.

Measures recall@k of collision-count, Hamming, and cosine-reranked
retrieval against brute-force exact search on synthetic GloVe-like data
(normalised Gaussian mixture — clustered, like real embedding spaces),
optionally sweeping the auto-tuner's similarity threshold.

Because this framework reproduces the reference's signature scheme
bit-for-bit (same projections, same banding, same candidate semantics),
these curves are the reference's recall curves; they quantify the
band/row auto-tuner's operating points.

Ground truth is computed on device (one matmul per query block), so the
benchmark scales to 1M+ base vectors.

Usage:
    python benchmarks/recall_bench.py [--n 1048576] [--dim 256] \
        [--thresholds 0.5 0.7 0.8 0.9]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def make_clustered(n: int, dim: int, n_clusters: int, rng) -> np.ndarray:
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    x = centers[assign] + 0.35 * rng.standard_normal((n, dim)).astype(np.float32)
    return x.astype(np.float32)


def make_heavy_tailed(n: int, dim: int, n_clusters: int, rng) -> np.ndarray:
    """GloVe-like embeddings: Zipf cluster sizes, anisotropic axis scales.

    Word-embedding spaces have a few huge semantic neighborhoods, a long
    tail of tiny ones, and variance concentrated in leading directions;
    this generator reproduces both properties.
    """
    sizes = 1.0 / np.arange(1, n_clusters + 1)  # Zipf(1) cluster mass
    probs = sizes / sizes.sum()
    assign = rng.choice(n_clusters, size=n, p=probs)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    # per-axis scales decay like 1/sqrt(rank): anisotropic, heavy leading dims
    axis_scale = (1.0 / np.sqrt(np.arange(1, dim + 1))).astype(np.float32)
    noise = rng.standard_normal((n, dim)).astype(np.float32) * axis_scale[None, :]
    x = centers[assign] * axis_scale[None, :] * 3.0 + 0.5 * noise
    return x.astype(np.float32)


def exact_topk_device(
    base: np.ndarray, queries: np.ndarray, k: int, metric: str = "cosine"
) -> np.ndarray:
    """Brute-force top-k on device (base uploaded once)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def block(bn_dev, qn_dev):
        sims = jnp.dot(qn_dev, bn_dev.T, preferred_element_type=jnp.float32)
        _, idx = jax.lax.top_k(sims, k)
        return idx

    if metric == "dot":
        bn, qn = base, queries
    else:
        bn = base / np.linalg.norm(base, axis=1, keepdims=True)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    bn_dev = jax.device_put(jnp.asarray(bn))
    return np.asarray(block(bn_dev, jnp.asarray(qn)))


def recall(got_rows, gt: np.ndarray, k: int) -> float:
    return float(
        np.mean(
            [
                len(set(int(i) for i in row) & set(t.tolist())) / k
                for row, t in zip(got_rows, gt)
            ]
        )
    )


def run_threshold(base, queries, gt, threshold, args) -> dict:
    from lshrs_tpu import LSHRS

    is_cp = args.hash_family == "crosspolytope"
    lsh = LSHRS(
        dim=args.dim,
        num_perm=args.num_perm,
        num_bands=args.bands,
        rows_per_band=args.rows,
        similarity_threshold=threshold,
        store_vectors=args.rerank or args.retrain > 0,
        # bit-semantic estimators (Hamming/asymmetric) are undefined over
        # cross-polytope argmax symbols and rejected at construction
        enable_hamming=not is_cp,
        initial_capacity=1 << max(14, (args.n - 1).bit_length()),
        hash_mode="host",
        hash_family=args.hash_family,
        dedupe=False,
        similarity=args.similarity,
        max_norm=getattr(args, "_max_norm", None),
        payload_dtype=args.payload_dtype,
        # Pin the collision engine: this bench labels its columns by
        # ESTIMATOR, and engine="auto" silently re-ranks query_batch by
        # Hamming past 512k slots (the column would then duplicate the
        # Hamming row, as a 1M run demonstrated).
        engine="collision",
    )
    t0 = time.perf_counter()
    lsh.index(np.arange(args.n), base)
    build_s = time.perf_counter() - t0
    itq_info = None
    if args.retrain > 0:
        # Fit ITQ learned hyperplanes to the indexed payload and rebuild
        # the signatures in place; every estimator below then measures
        # the LEARNED family at identical memory/banding.
        t0 = time.perf_counter()
        itq_info = lsh.retrain(iters=args.retrain)
        itq_info["retrain_s"] = round(time.perf_counter() - t0, 2)
    stats = lsh.stats()
    store = lsh._storage

    k = args.k
    t0 = time.perf_counter()
    got = lsh.query_batch(queries, top_k=k)
    query_s = time.perf_counter() - t0
    r_coll = recall(got, gt, k)

    q_aug = lsh._augment_query(queries)
    out = {
        "threshold": threshold,
        "family": "learned(itq)" if args.retrain > 0 else args.hash_family,
        "bands": f"{stats['num_bands']}x{stats['rows_per_band']}",
        f"recall@{k}_collision": round(r_coll, 4),
        "build_s": round(build_s, 2),
        "query_batch_s": round(query_s, 3),
        "signature_mb": round(stats["index"]["signature_bytes"] / 2**20, 1),
    }
    if not is_cp:
        # hamming (full-signature) recall — same hash path as indexing
        # (store-level calls bypass the orchestrator, so apply the MIPS
        # query augmentation explicitly; identity for cosine)
        qwords = lsh._hasher.hash_batch_words_host(q_aug)
        _, ham_ids = store.query_hamming(qwords, k)
        out[f"recall@{k}_hamming"] = round(
            recall([row[row >= 0] for row in ham_ids], gt, k), 4
        )

        # asymmetric SimHash recall — query keeps quantised coordinates
        asym_rows = lsh.query_asymmetric_batch(queries, top_k=k)
        out[f"recall@{k}_asymmetric"] = round(
            recall([[i for i, _ in row] for row in asym_rows], gt, k), 4
        )
        # honest memory: Hamming bitplanes cost num_perm bytes/vector on
        # top of the num_perm/8-byte packed signature
        out["hamming_extra_mb"] = round(
            stats["index"]["capacity"] * args.num_perm / 2**20, 1
        )
    if itq_info is not None:
        out["itq"] = {
            key: itq_info[key]
            for key in ("fitted_bits", "padded_bits", "bit_bias", "retrain_s")
        }

    if args.rerank:
        scored = lsh.get_above_p_batch(queries, p=1.0, top_k=k)
        out[f"recall@{k}_reranked"] = round(
            recall([[i for i, _ in row] for row in scored], gt, k), 4
        )

    if args.multiprobe > 1:
        # Multi-probe collision (+ rerank): same index, zero extra memory —
        # the T-probe query words reuse every fused query path.
        t_probe = min(args.multiprobe, lsh._hasher.max_probes)
        qw_mp = lsh._hasher.hash_batch_probe_words_host(q_aug, t_probe)
        _, mp_ids = store.query_topk(qw_mp, k)
        out[f"recall@{k}_collision_mp{t_probe}"] = round(
            recall([row[row >= 0] for row in mp_ids], gt, k), 4
        )
        if args.rerank:
            ids_r, _, n_r = store.query_topp_batch(qw_mp, q_aug, k)
            out[f"recall@{k}_reranked_mp{t_probe}"] = round(
                recall([row[row >= 0] for row in ids_r], gt, k), 4
            )
    lsh._storage.close()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--num-perm", type=int, default=256)
    ap.add_argument("--bands", type=int, default=None,
                    help="force the banding instead of the threshold "
                    "auto-tuner (with --rows; bands*rows == num-perm)")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--thresholds", type=float, nargs="+", default=[0.8])
    ap.add_argument("--payload-dtype", choices=["float32", "bfloat16", "int8"],
                    default="float32",
                    help="resident payload precision for the rerank rows")
    ap.add_argument("--rerank", action="store_true",
                    help="also measure cosine-reranked recall (uploads the "
                    "full payload matrix to HBM)")
    ap.add_argument("--multiprobe", type=int, default=1,
                    help="also measure T-probe collision (and reranked, "
                    "with --rerank) recall at this probe depth — candidate "
                    "expansion at zero memory cost")
    ap.add_argument("--similarity", choices=["cosine", "dot"],
                    default="cosine",
                    help="'dot' switches the index to MIPS mode (simple-LSH "
                    "augmentation) and ranks ground truth by inner product; "
                    "base vectors get a 3x norm spread so the augmentation's "
                    "hard case is what gets measured")
    ap.add_argument("--hash-family",
                    choices=["gaussian", "structured", "crosspolytope"],
                    default="gaussian",
                    help="LSH projection family (structured = FWHT "
                    "rotations; crosspolytope = FALCONN signed-argmax "
                    "symbols — collision/rerank estimators only)")
    ap.add_argument("--retrain", type=int, default=0, metavar="ITERS",
                    help="fit ITQ learned hyperplanes on the indexed payload "
                    "(ITERS alternations, lshrs_tpu.hash.itq) and rebuild the "
                    "signatures in place before measuring — every estimator "
                    "column then reports the learned family at identical "
                    "memory and banding (implies store_vectors)")
    ap.add_argument("--dist", choices=["clustered", "heavy"], default="clustered",
                    help="base-data generator: Gaussian-mixture clusters or "
                    "GloVe-like heavy-tailed (Zipf clusters, anisotropic axes)")
    ap.add_argument("--source", default=None,
                    help="path to REAL embeddings (.npy 2-D float array, or "
                    ".npz whose first array is one) — e.g. GloVe/fastText "
                    "vectors exported with np.save. Overrides --dist/--dim/"
                    "--n; the last --queries rows are held out as queries "
                    "and the rest are indexed. This bench host has no "
                    "network egress, so real-dataset numbers must be "
                    "produced by pointing this flag at a local export.")
    args = ap.parse_args()

    import jax

    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/lshrs_tpu_jax_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass

    rng = np.random.default_rng(7)
    if args.source:
        arr = np.load(args.source, allow_pickle=False)
        if hasattr(arr, "files"):  # .npz: take the first array
            arr = arr[arr.files[0]]
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[0] <= args.queries:
            raise SystemExit(
                f"--source must be a 2-D array with more than "
                f"{args.queries} rows; got shape {arr.shape}"
            )
        # drop exact-zero rows (unindexable) then split held-out queries
        arr = arr[np.abs(arr).max(axis=1) > 1e-8]
        base, queries = arr[: -args.queries], arr[-args.queries :]
        args.n, args.dim = base.shape
        dist_label = f"source:{Path(args.source).name}"
    else:
        gen = make_clustered if args.dist == "clustered" else make_heavy_tailed
        base = gen(args.n, args.dim, n_clusters=max(1000, args.n // 1000), rng=rng)
        if args.similarity == "dot":
            # the augmentation's hard case: a 3x stored-norm spread
            base *= rng.uniform(0.5, 1.5, (args.n, 1)).astype(np.float32)
        q_idx = rng.permutation(args.n)[: args.queries]
        queries = base[q_idx] + 0.05 * rng.standard_normal(
            (args.queries, args.dim)
        ).astype(np.float32)
        dist_label = args.dist

    if args.similarity == "dot":
        args._max_norm = float(np.linalg.norm(base, axis=1).max()) * 1.001
    gt = exact_topk_device(base, queries, args.k, metric=args.similarity)

    for t in args.thresholds:
        row = run_threshold(base, queries, gt, t, args)
        row.update({
            "n": args.n, "dim": args.dim, "num_perm": args.num_perm,
            "dist": dist_label, "similarity": args.similarity,
        })
        print(json.dumps(row))


if __name__ == "__main__":
    main()
