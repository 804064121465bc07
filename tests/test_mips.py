"""MIPS (maximum inner-product search): ``similarity="dot"``.

Simple-LSH augmentation (Neyshabur & Srebro 2015): stored vectors gain a
coordinate ``sqrt(max_norm^2 - |x|^2)`` (constant augmented norm), queries
a literal 0, so augmented cosine equals ``(q.x) / (|q| * max_norm)`` —
inner-product ORDER under every cosine stage, and returned scores rescale
back to exact inner products. The reference is cosine-only
(`/root/reference/lshrs/utils/similarity.py`); this is a device
capability extension.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from lshrs_tpu import LSHRS

DIM = 24


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(99)


@pytest.fixture
def data(rng):
    X = rng.standard_normal((600, DIM)).astype(np.float32)
    X *= rng.uniform(0.4, 1.8, (600, 1)).astype(np.float32)
    M = float(np.linalg.norm(X, axis=1).max()) * 1.001
    return X, M


def make_mips(data, **kw):
    X, M = data
    kw.setdefault("num_perm", 64)
    kw.setdefault("num_bands", 8)
    kw.setdefault("rows_per_band", 8)
    kw.setdefault("engine", "collision")
    kw.setdefault("initial_capacity", 1024)
    lsh = LSHRS(dim=DIM, similarity="dot", max_norm=M, **kw)
    lsh.index(np.arange(len(X)), X)
    return lsh


def test_validation():
    with pytest.raises(ValueError, match="max_norm"):
        LSHRS(dim=DIM, similarity="dot")
    with pytest.raises(ValueError, match="max_norm"):
        LSHRS(dim=DIM, similarity="dot", max_norm=0.0)
    with pytest.raises(ValueError, match="similarity"):
        LSHRS(dim=DIM, similarity="euclidean")


def test_over_norm_vectors_rejected(data, rng):
    X, M = data
    lsh = make_mips(data)
    big = rng.standard_normal((1, DIM)).astype(np.float32)
    big *= (2.0 * M) / np.linalg.norm(big)
    with pytest.raises(ValueError, match="max_norm"):
        lsh.index([10_000], big)
    with pytest.raises(ValueError, match="max_norm"):
        lsh.ingest(10_001, big[0])


def test_topp_scores_are_exact_inner_products(data, rng):
    X, M = data
    lsh = make_mips(data, store_vectors=True)
    for q in rng.standard_normal((5, DIM)).astype(np.float32):
        dots = X @ q
        res = lsh.get_above_p(q, p=1.0)
        assert res, "empty candidate set"
        ids = [i for i, _ in res]
        # ordering follows the inner product among returned candidates
        assert ids == sorted(ids, key=lambda i: (-dots[i], i))
        for i, s in res:
            assert s == pytest.approx(float(dots[i]), rel=1e-4, abs=1e-4)


def test_topp_fetch_fn_path_matches_resident(data, rng):
    """Host (vector_fetch_fn) rerank == device resident-payload rerank."""
    X, M = data
    resident = make_mips(data, store_vectors=True)
    fetched = make_mips(data, vector_fetch_fn=lambda ids: X[list(ids)])
    for q in rng.standard_normal((3, DIM)).astype(np.float32):
        r1 = resident.get_above_p(q, p=0.5)
        r2 = fetched.get_above_p(q, p=0.5)
        assert [i for i, _ in r1] == [i for i, _ in r2]
        for (_, s1), (_, s2) in zip(r1, r2):
            assert s1 == pytest.approx(s2, rel=1e-4, abs=1e-4)


def test_batched_topp_matches_single(data, rng):
    X, M = data
    lsh = make_mips(data, store_vectors=True)
    queries = rng.standard_normal((6, DIM)).astype(np.float32)
    batch = lsh.get_above_p_batch(queries, p=1.0)
    for qi, q in enumerate(queries):
        single = lsh.get_above_p(q, p=1.0)
        assert [i for i, _ in batch[qi]] == [i for i, _ in single]
        for (_, sb), (_, ss) in zip(batch[qi], single):
            assert sb == pytest.approx(ss, rel=1e-4, abs=1e-4)


def test_hamming_and_asymmetric_estimate_dots(data, rng):
    """Estimator modes return inner-product-scaled estimates in dot mode."""
    X, M = data
    lsh = make_mips(
        data, num_perm=256, num_bands=16, rows_per_band=16,
        enable_hamming=True,
    )
    q = rng.standard_normal(DIM).astype(np.float32)
    dots = X @ q
    top = lsh.query_hamming(q, top_k=5)
    # estimates live on the inner-product scale (not in [-1, 1])
    for i, est in top:
        assert abs(est - dots[i]) < 0.6 * M * np.linalg.norm(q)
    asym = lsh.query_asymmetric(q, top_k=5)
    for i, est in asym:
        assert abs(est - dots[i]) < 0.6 * M * np.linalg.norm(q)
    # batch variants agree with singles
    hb = lsh.query_hamming_batch(q[None, :], top_k=5)[0]
    assert [i for i, _ in hb] == [i for i, _ in top]


def test_mips_recall_with_rich_banding(rng):
    """End-to-end recall sanity: probing rerank finds most true top-10."""
    dim, n = 32, 6000
    centers = rng.standard_normal((60, dim)).astype(np.float32) * 2
    X = np.repeat(centers, 100, axis=0) + 0.4 * rng.standard_normal(
        (n, dim)
    ).astype(np.float32)
    X *= rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    M = float(np.linalg.norm(X, axis=1).max()) * 1.001
    lsh = LSHRS(
        dim=dim, num_perm=256, num_bands=32, rows_per_band=8,
        similarity="dot", max_norm=M, store_vectors=True,
        engine="collision", multiprobe=2, initial_capacity=8192,
    )
    lsh.index(np.arange(n), X)
    hits = tot = 0
    for q in rng.standard_normal((24, dim)).astype(np.float32):
        dots = X @ q
        oracle = set(np.argsort(-dots)[:10].tolist())
        got = set(i for i, _ in lsh.get_above_p(q, p=1.0)[:10])
        hits += len(got & oracle)
        tot += 10
    assert hits / tot > 0.5, f"MIPS recall@10 {hits / tot:.3f}"


def test_serving_fn_topp_rescales(data, rng):
    X, M = data
    lsh = make_mips(data, store_vectors=True)
    serve = lsh.serving_fn(top_k=8, mode="topp")
    queries = rng.standard_normal((4, DIM)).astype(np.float32)
    ids, sims, n = serve(queries)
    for qi, q in enumerate(queries):
        dots = X @ q
        for j in range(min(8, int(n[qi]))):
            i = int(ids[qi, j])
            if i < 0:
                break
            assert sims[qi, j] == pytest.approx(
                float(dots[i]), rel=1e-4, abs=1e-4
            )


def test_persistence_roundtrip(data, rng, tmp_path):
    X, M = data
    lsh = make_mips(data, store_vectors=True)
    q = rng.standard_normal(DIM).astype(np.float32)
    want = lsh.get_above_p(q, p=1.0)[:10]

    lsh.save_to_disk(tmp_path / "mips")
    restored = LSHRS.load_from_disk(tmp_path / "mips")
    assert restored._similarity == "dot"
    assert restored._max_norm == pytest.approx(M)
    assert restored.stats()["similarity"] == "dot"
    got = restored.get_above_p(q, p=1.0)[:10]
    assert [i for i, _ in got] == [i for i, _ in want]

    clone = pickle.loads(pickle.dumps(lsh))
    got = clone.get_above_p(q, p=1.0)[:10]
    assert [i for i, _ in got] == [i for i, _ in want]


def test_bucket_backend_matches_device(data, rng):
    """MIPS candidate semantics agree across backends (same hash space)."""
    X, M = data
    device = make_mips(data)
    bucket = LSHRS(
        dim=DIM, similarity="dot", max_norm=M, num_perm=64, num_bands=8,
        rows_per_band=8, backend="memory",
        vector_fetch_fn=lambda ids: X[list(ids)],
    )
    bucket.index(np.arange(len(X)), X)
    for q in rng.standard_normal((5, DIM)).astype(np.float32):
        assert bucket.query(q, top_k=None) == device.query(q, top_k=None)


def test_sharded_mips_matches_single(data, rng):
    """8-shard MIPS == single-device MIPS (ids and exact dot scores)."""
    import jax

    assert len(jax.devices()) >= 8
    X, M = data
    single = make_mips(data, store_vectors=True)
    sharded = LSHRS(
        dim=DIM, similarity="dot", max_norm=M, num_perm=64, num_bands=8,
        rows_per_band=8, engine="collision", initial_capacity=1024,
        store_vectors=True, shards=8,
    )
    sharded.index(np.arange(len(X)), X)
    for q in rng.standard_normal((4, DIM)).astype(np.float32):
        r1 = single.get_above_p(q, p=1.0)
        r2 = sharded.get_above_p(q, p=1.0)
        assert [i for i, _ in r1] == [i for i, _ in r2]
        for (_, s1), (_, s2) in zip(r1, r2):
            assert s1 == pytest.approx(s2, rel=1e-5, abs=1e-6)
