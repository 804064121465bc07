"""Train REAL distributional word embeddings from a local corpus.

The recall north star asks for real embedding geometry (GloVe-1M), but
this bench host has no network egress. This script removes the synthetic
stand-in by training genuine distributional embeddings with the same
family of method GloVe belongs to — windowed co-occurrence counts +
PPMI weighting + truncated SVD (Levy & Goldberg 2014 showed this
factorization is what skip-gram/GloVe implicitly compute) — over a real
local text corpus: the Python source installed on the machine
(docstrings, comments, identifiers; hundreds of MB). The result has the
properties that make embedding ANN hard and that the synthetic
generators only imitate: Zipf-distributed vocabulary, anisotropic
spectrum, genuine semantic neighborhoods (e.g. numeric / networking /
testing clusters).

Output: ``<out>.npy`` — a ``(vocab, dim)`` float32 matrix fed straight
into ``recall_bench.py --source`` — and ``<out>.vocab.txt``.

Usage:
    python benchmarks/corpus_embeddings.py --out /tmp/corpus_emb \
        [--dim 256] [--vocab 50000] [--max-mb 200]
    python benchmarks/recall_bench.py --source /tmp/corpus_emb.npy ...
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_WORD = re.compile(rb"[A-Za-z]{2,}")


def iter_corpus_files(roots, max_bytes: int):
    seen = 0
    for root in roots:
        for dirpath, _, names in os.walk(root):
            for n in sorted(names):
                if not n.endswith((".py", ".pyi", ".txt", ".md", ".rst")):
                    continue
                p = os.path.join(dirpath, n)
                try:
                    size = os.path.getsize(p)
                except OSError:
                    continue
                if size > 8 << 20:  # skip generated monsters
                    continue
                if seen + size > max_bytes:
                    return
                seen += size
                yield p


def tokenize(path: str) -> list[bytes]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    return [m.group(0).lower() for m in _WORD.finditer(data)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/corpus_emb")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--min-count", type=int, default=5)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--max-mb", type=int, default=200)
    ap.add_argument("--roots", nargs="*", default=None,
                    help="corpus roots (default: this Python's site-packages)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--contexts", type=int, default=0,
                    help="additionally emit this many sliding-window "
                    "passage vectors (<out>.ctx.npy) — idf-weighted means "
                    "of the word embeddings over --ctx-window token "
                    "windows. This is how the real-geometry corpus scales "
                    "past the vocabulary size (dense-retrieval shape: "
                    "~1M real passage vectors from a few hundred MB of "
                    "text).")
    ap.add_argument("--ctx-window", type=int, default=64)
    args = ap.parse_args()

    import scipy.sparse as sp

    import site

    roots = args.roots or [
        *site.getsitepackages(),
        os.path.join(os.path.dirname(os.__file__), "site-packages"),
        os.path.dirname(os.__file__),
    ]
    roots = [r for r in roots if os.path.isdir(r)]
    t0 = time.perf_counter()
    tokens: list[bytes] = []
    nfiles = 0
    for p in iter_corpus_files(roots, args.max_mb << 20):
        tokens.extend(tokenize(p))
        nfiles += 1
    print(f"corpus: {nfiles} files, {len(tokens):,} tokens "
          f"({time.perf_counter()-t0:.1f}s)", file=sys.stderr, flush=True)

    counts = Counter(tokens)
    vocab = [w for w, c in counts.most_common(args.vocab) if c >= args.min_count]
    wid = {w: i for i, w in enumerate(vocab)}
    v = len(vocab)
    ids = np.fromiter(
        (wid.get(t, -1) for t in tokens), dtype=np.int32, count=len(tokens)
    )
    ids = ids[ids >= 0]  # drop OOV, keeping adjacency approximately
    n_tok = ids.size
    print(f"vocab {v:,}, in-vocab tokens {n_tok:,}", file=sys.stderr, flush=True)

    # windowed co-occurrence with 1/d weighting (GloVe's scheme), symmetric
    t0 = time.perf_counter()
    cooc = sp.csr_matrix((v, v), dtype=np.float32)
    for d in range(1, args.window + 1):
        i, j = ids[:-d], ids[d:]
        w = np.full(i.shape[0], 1.0 / d, dtype=np.float32)
        m = sp.coo_matrix((w, (i, j)), shape=(v, v)).tocsr()
        cooc = cooc + m + m.T
    print(f"co-occurrence: nnz {cooc.nnz:,} ({time.perf_counter()-t0:.1f}s)",
          file=sys.stderr, flush=True)

    # PPMI: log( P(i,j) / (P(i) P(j)) ), clipped at 0
    t0 = time.perf_counter()
    total = cooc.sum()
    row = np.asarray(cooc.sum(axis=1)).ravel()
    col = np.asarray(cooc.sum(axis=0)).ravel()
    coo = cooc.tocoo()
    pmi = np.log(
        (coo.data * total) / (row[coo.row] * col[coo.col])
    ).astype(np.float32)
    keep = pmi > 0
    ppmi = sp.csr_matrix(
        (pmi[keep], (coo.row[keep], coo.col[keep])), shape=(v, v)
    )
    print(f"PPMI: nnz {ppmi.nnz:,} ({time.perf_counter()-t0:.1f}s)",
          file=sys.stderr, flush=True)

    # randomized SVD via sparse matmuls (Halko et al.): 2 passes + small QR
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    k, p_over = args.dim, 16
    omega = rng.standard_normal((v, k + p_over)).astype(np.float32)
    y = ppmi @ omega
    q, _ = np.linalg.qr(y)
    # one subspace iteration sharpens the spectrum estimate
    q, _ = np.linalg.qr(ppmi.T @ q)
    q, _ = np.linalg.qr(ppmi @ q)
    b = q.T @ ppmi  # (k+p, v) dense — small
    u_small, s, _ = np.linalg.svd(b, full_matrices=False)
    emb = (q @ u_small[:, :k]) * np.sqrt(s[:k])[None, :]
    emb = emb.astype(np.float32)
    # drop near-zero rows (words with no positive PMI signal)
    norms = np.linalg.norm(emb, axis=1)
    alive = norms > 1e-6
    emb = emb[alive]
    kept = [w for w, a in zip(vocab, alive) if a]
    print(f"SVD: dim {k}, {emb.shape[0]:,} embeddings "
          f"({time.perf_counter()-t0:.1f}s); spectrum head {s[:5].round(1)}",
          file=sys.stderr, flush=True)

    ctx_report = {}
    if args.contexts:
        # Sliding-window passage vectors: each window of ctx_window
        # in-vocab tokens -> idf-weighted mean of its words' embeddings,
        # L2-normalized. Real dense-retrieval geometry (passages sharing
        # topical vocabulary are genuine near neighbours; overlapping
        # windows contribute realistic near-duplicates) at corpus scale
        # rather than vocabulary scale. Composed BEFORE the row shuffle
        # so `alive` still aligns with the vocab ids.
        t0 = time.perf_counter()
        remap = np.full(v, -1, np.int32)
        remap[np.flatnonzero(alive)] = np.arange(int(alive.sum()))
        cids = remap[ids]
        cids = cids[cids >= 0]
        wcount = np.bincount(cids, minlength=emb.shape[0]).astype(np.float64)
        idf = np.log(cids.size / np.maximum(wcount, 1.0)).astype(np.float32)
        w_tok = idf[cids]  # per-token weight
        W = args.ctx_window
        stride = max(1, (cids.size - W) // args.contexts)
        starts = np.arange(0, cids.size - W, stride)[: args.contexts]
        ctx = np.empty((starts.size, emb.shape[1]), np.float32)
        slab = 1 << 19  # tokens per slab: ~512 MB cumsum transient at 256d
        out_i = 0
        for s0 in range(0, cids.size - W, slab):
            s1 = min(s0 + slab + W, cids.size)
            # half-open slab ownership: a start on the boundary belongs to
            # ONE slab (start+W <= s1 always holds for owned starts, since
            # max(starts) <= cids.size - W - 1 and s1 covers s0+slab+W)
            sel = starts[(starts >= s0) & (starts < s0 + slab)]
            if sel.size == 0:
                continue
            rows = emb[cids[s0:s1]] * w_tok[s0:s1, None]
            cs = np.concatenate(
                [np.zeros((1, rows.shape[1]), np.float64),
                 np.cumsum(rows, axis=0, dtype=np.float64)]
            )
            block = (cs[sel - s0 + W] - cs[sel - s0]).astype(np.float32)
            ctx[out_i:out_i + sel.size] = block
            out_i += sel.size
        ctx = ctx[:out_i]
        cn = np.linalg.norm(ctx, axis=1)
        ctx = ctx[cn > 1e-6] / cn[cn > 1e-6, None]
        ctx = ctx[rng.permutation(ctx.shape[0])]
        np.save(args.out + ".ctx.npy", ctx)
        ctx_report = {
            "contexts": int(ctx.shape[0]),
            "ctx_window": W,
            "ctx_stride": int(stride),
            "ctx_out": args.out + ".ctx.npy",
        }
        print(f"contexts: {ctx.shape[0]:,} x {emb.shape[1]} "
              f"(window {W}, stride {stride}, "
              f"{time.perf_counter()-t0:.1f}s)", file=sys.stderr, flush=True)

    # shuffle rows so recall_bench's tail held-out split samples words
    # uniformly (the natural order is frequency-sorted)
    perm = rng.permutation(emb.shape[0])
    emb = emb[perm]
    kept = [kept[i] for i in perm]
    np.save(args.out + ".npy", emb)
    with open(args.out + ".vocab.txt", "wb") as f:
        f.write(b"\n".join(kept))
    print(json.dumps({
        "metric": "corpus_embeddings",
        "out": args.out + ".npy",
        "vocab": emb.shape[0],
        "dim": k,
        "tokens": int(n_tok),
        "cooc_nnz": int(cooc.nnz),
        "singular_head": [round(float(x), 1) for x in s[:5]],
        **ctx_report,
    }))


if __name__ == "__main__":
    main()
