"""Learned (ITQ) hash family: fit, hasher plumbing, and `LSHRS.retrain`.

The reference's projections are frozen seeded gaussians
(`/root/reference/lshrs/hash/lsh.py:93-94`); `lshrs_tpu.hash.itq` fits
data-dependent hyperplanes and `LSHRS.retrain` swaps them in without
re-ingestion. These tests pin the fit's math (orthonormality,
determinism, padding), the measurable quality claims (bit balance,
Hamming-ranking recall on structured data), and the full orchestrator
integration (rebuild exactness, persistence, pickle, staleness,
re-banding, MIPS augmentation, post-retrain ingest).
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from lshrs_tpu import LSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.hash.itq import fit_itq_projection, itq_fit_info


def _lowrank_data(rng, n, dim, rank=6, noise=0.05):
    """Anisotropic data: a few signal directions + isotropic noise —
    the regime where data-oblivious hyperplanes waste bits."""
    basis = rng.standard_normal((rank, dim)).astype(np.float32)
    z = rng.standard_normal((n, rank)).astype(np.float32)
    x = z @ basis + noise * rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _hamming_recall(proj, base, queries, gt, k=10):
    """recall@k of full-code Hamming ranking against cosine ground truth."""
    xb = np.where(base @ proj.T > 0, 1, -1).astype(np.float32)
    qb = np.where(queries @ proj.T > 0, 1, -1).astype(np.float32)
    agree = qb @ xb.T
    top = np.argsort(-agree, axis=1, kind="stable")[:, :k]
    hits = sum(len(set(t) & set(g)) for t, g in zip(top, gt))
    return hits / (k * len(queries))


# -- fit math -----------------------------------------------------------------


def test_fit_shapes_orthonormal_deterministic(rng):
    x = _lowrank_data(rng, 500, 32)
    p1 = fit_itq_projection(x, 16, seed=3)
    p2 = fit_itq_projection(x, 16, seed=3)
    assert p1.shape == (16, 32) and p1.dtype == np.float32
    np.testing.assert_array_equal(p1, p2)  # deterministic
    # fitted rows are orthonormal (W R has orthonormal columns)
    np.testing.assert_allclose(p1 @ p1.T, np.eye(16), atol=1e-4)
    p3 = fit_itq_projection(x, 16, seed=4)
    assert not np.array_equal(p1, p3)  # seed moves the rotation


def test_fit_pads_beyond_dim(rng):
    x = _lowrank_data(rng, 200, 8)
    p, info = fit_itq_projection(x, 32, seed=0, return_info=True)
    assert p.shape == (32, 8)
    # one dimension goes to the mean deflation; the rest pad with gaussian
    assert info["fitted_bits"] == 7 and info["padded_bits"] == 25
    assert info["deflated_mean"]
    # the fitted block is still orthonormal; padding is gaussian
    np.testing.assert_allclose(p[:7] @ p[:7].T, np.eye(7), atol=1e-4)


def test_fit_validation(rng):
    with pytest.raises(ValueError, match="2D"):
        fit_itq_projection(np.ones(8, np.float32), 4)
    with pytest.raises(ValueError, match="at least 2"):
        fit_itq_projection(np.ones((1, 8), np.float32), 4)
    with pytest.raises(ValueError, match="zero vectors"):
        fit_itq_projection(np.zeros((4, 8), np.float32), 4)
    with pytest.raises(ValueError, match="num_perm"):
        fit_itq_projection(np.ones((4, 8), np.float32), 0)
    # zero rows are dropped, not fatal
    x = np.concatenate([_lowrank_data(rng, 50, 8), np.zeros((2, 8), np.float32)])
    assert fit_itq_projection(x, 8).shape == (8, 8)


def test_fit_balances_biased_bits(rng):
    """Data with a large mean drives gaussian hyperplane bits far from
    balance; the learned rotation spreads that energy."""
    x = _lowrank_data(rng, 800, 32) + 2.0  # strong common direction
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    learned = fit_itq_projection(x, 32, seed=7)
    gaussian = LSHHasher(num_bands=8, rows_per_band=4, dim=32, seed=7)
    bias_learned = itq_fit_info(x, learned)["bit_bias"]
    bias_gauss = itq_fit_info(x, gaussian.projection_matrix)["bit_bias"]
    assert bias_learned < bias_gauss


def test_learned_beats_gaussian_recall_on_structured_data(rng):
    """The headline claim: with FEWER BITS THAN INTRINSIC DIMENSIONS
    (the production regime — e.g. 256 bits over 768d embeddings) and an
    anisotropic spectrum, learned codes rank neighbors better than
    random hyperplanes at equal bits. (The converse regime — bits well
    beyond the data's intrinsic rank — favors random hyperplanes, whose
    every bit mixes in some signal.)"""
    dim, n, nq, bits = 64, 3000, 64, 16
    scales = (1.0 / np.sqrt(1.0 + np.arange(dim))).astype(np.float32)
    base = rng.standard_normal((n, dim)).astype(np.float32) * scales
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    queries = base[:nq] + 0.05 * rng.standard_normal(
        (nq, dim)
    ).astype(np.float32) * scales
    sims = queries @ base.T / np.linalg.norm(queries, axis=1, keepdims=True)
    gt = np.argsort(-sims, axis=1)[:, :10]
    learned = fit_itq_projection(base, bits, seed=5)
    gaussian = LSHHasher(num_bands=4, rows_per_band=4, dim=dim, seed=5)
    r_learned = _hamming_recall(learned, base, queries, gt)
    r_gauss = _hamming_recall(gaussian.projection_matrix, base, queries, gt)
    assert r_learned > r_gauss + 0.03, (r_learned, r_gauss)


# -- hasher plumbing ----------------------------------------------------------


def test_hasher_learned_family(rng):
    x = _lowrank_data(rng, 200, 16)
    p = fit_itq_projection(x, 16, seed=1)
    h = LSHHasher(num_bands=4, rows_per_band=4, dim=16, hash_family="learned",
                  projection=p)
    np.testing.assert_array_equal(h.projection_matrix, p)
    # per-band views slice the learned matrix
    np.testing.assert_array_equal(h.projections[1], p[4:8])
    # batch words equal the numpy oracle bits
    words = h.hash_batch_words_host(x[:32])
    h2 = LSHHasher(num_bands=4, rows_per_band=4, dim=16, hash_family="learned")
    h2.projections = [p[i * 4 : (i + 1) * 4] for i in range(4)]
    np.testing.assert_array_equal(words, h2.hash_batch_words_host(x[:32]))
    # multiprobe + coords paths run on the learned family
    assert h.hash_batch_probe_words_host(x[:8], 2).shape == (8, 2, 4)
    assert h.hash_batch_coords_host(x[:8]).shape == (8, 16)


def test_hasher_learned_validation():
    with pytest.raises(ValueError, match="hash_family"):
        LSHHasher(num_bands=2, rows_per_band=4, dim=8, hash_family="itq")
    with pytest.raises(ValueError, match="requires hash_family='learned'"):
        LSHHasher(num_bands=2, rows_per_band=4, dim=8,
                  projection=np.ones((8, 8), np.float32))
    with pytest.raises(ValueError, match="shape"):
        LSHHasher(num_bands=2, rows_per_band=4, dim=8, hash_family="learned",
                  projection=np.ones((4, 8), np.float32))
    # structured family still refuses projection assignment
    s = LSHHasher(num_bands=2, rows_per_band=4, dim=8, hash_family="structured")
    with pytest.raises(ValueError, match="gaussian and"):
        s.projections = [np.ones((4, 8), np.float32)] * 2


# -- orchestrator integration -------------------------------------------------


def _device_lsh(rng, n=400, dim=32, **kw):
    kw.setdefault("num_perm", 16)
    kw.setdefault("num_bands", 4)
    kw.setdefault("rows_per_band", 4)
    lsh = LSHRS(dim=dim, backend="device", store_vectors=True, seed=42,
                chunk_size=128, initial_capacity=128, **kw)
    X = _lowrank_data(rng, n, dim)
    lsh.index(list(range(n)), X)
    return lsh, X


def test_retrain_end_to_end(rng):
    lsh, X = _device_lsh(rng)
    info = lsh.retrain(iters=16)
    assert info["fitted_bits"] == 16 and info["padded_bits"] == 0
    assert lsh._tpu_config["hash_family"] == "learned"
    assert lsh._hasher.hash_family == "learned"
    # f32 payload: rebuilt signatures match the learned hasher exactly,
    # so self-queries collide in every band
    idx, count = lsh._ordered_candidates(X[9])[0]
    assert idx == 9 and count == 4
    res = lsh.get_above_p(X[17], p=0.1)
    assert res[0][0] == 17 and res[0][1] > 0.9999


def test_retrain_explicit_sample_and_cap(rng):
    lsh, X = _device_lsh(rng)
    info = lsh.retrain(sample=X[:100], iters=8, sample_cap=64)
    assert info["sample_rows"] == 64  # capped, strided
    assert lsh.get_top_k(X[3], topk=1)[0] == 3


def test_retrain_then_ingest_uses_learned_family(rng):
    """Vectors indexed AFTER retrain hash through the learned matrix on
    the fused device-build path."""
    lsh, X = _device_lsh(rng)
    lsh.retrain(iters=8)
    extra = _lowrank_data(rng, 50, 32)
    lsh.index(list(range(1000, 1050)), extra)
    idx, count = lsh._ordered_candidates(extra[7])[0]
    assert idx == 1007 and count == 4


def test_retrain_persistence_and_pickle(rng, tmp_path):
    lsh, X = _device_lsh(rng)
    lsh.retrain(iters=8)
    before = lsh.get_above_p(X[4], p=0.5)
    proj = lsh._hasher.projection_matrix.copy()

    lsh.save_to_disk(tmp_path / "idx")
    re = LSHRS.load_from_disk(tmp_path / "idx")
    assert re._hasher.hash_family == "learned"
    np.testing.assert_array_equal(re._hasher.projection_matrix, proj)
    after = re.get_above_p(X[4], p=0.5)
    assert [i for i, _ in before] == [i for i, _ in after]

    pk = pickle.loads(pickle.dumps(lsh))
    assert pk._hasher.hash_family == "learned"
    np.testing.assert_array_equal(pk._hasher.projection_matrix, proj)
    assert pk.get_top_k(X[11], topk=1)[0] == 11


def test_retrain_staleness_guard(rng):
    lsh, X = _device_lsh(rng)
    fn = lsh.serving_fn(1)
    lsh.retrain(iters=4)
    with pytest.raises(RuntimeError, match="stale"):
        fn(X[:4])


def test_rehash_rebands_learned_matrix(rng):
    """Re-banding after retrain carries the learned matrix; changing
    num_perm demands a fresh fit."""
    lsh, X = _device_lsh(rng)
    lsh.retrain(iters=8)
    proj = lsh._hasher.projection_matrix.copy()
    lsh.rehash(num_bands=8, rows_per_band=2)
    assert lsh._hasher.hash_family == "learned"
    np.testing.assert_array_equal(lsh._hasher.projection_matrix, proj)
    idx, count = lsh._ordered_candidates(X[9])[0]
    assert idx == 9 and count == 8
    with pytest.raises(ValueError, match="retrain"):
        lsh.rehash(num_bands=8, rows_per_band=8)


def test_retrain_mips_augments_sample(rng):
    X = _lowrank_data(rng, 300, 16) * 2.0
    lsh = LSHRS(dim=16, backend="device", store_vectors=True,
                num_perm=16, num_bands=4, rows_per_band=4,
                similarity="dot", max_norm=4.0,
                chunk_size=128, initial_capacity=128)
    lsh.index(list(range(300)), X)
    info = lsh.retrain(sample=X[:200], iters=8)
    # the fit sees the augmented (dim + 1) geometry
    assert lsh._hasher.projection_matrix.shape == (16, 17)
    assert info["fitted_bits"] == 16
    got = lsh.get_above_p(X[5], p=0.05)
    assert got[0][0] == 5
    np.testing.assert_allclose(got[0][1], float(X[5] @ X[5]), rtol=1e-4)


def test_retrain_validation(rng):
    mem = LSHRS(dim=8, num_perm=16, backend="memory")
    with pytest.raises(RuntimeError, match="device backend"):
        mem.retrain()
    no_payload = LSHRS(dim=8, num_perm=16, backend="device",
                       chunk_size=128, initial_capacity=128)
    with pytest.raises(RuntimeError, match="store_vectors"):
        no_payload.retrain()
    lsh, _ = _device_lsh(rng)
    with pytest.raises(ValueError, match="shape"):
        lsh.retrain(sample=np.ones((10, 7), np.float32))
    empty = LSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4,
                  backend="device", store_vectors=True,
                  chunk_size=128, initial_capacity=128)
    with pytest.raises(RuntimeError, match="at least 2"):
        empty.retrain()


def test_retrain_sharded(rng):
    """Sharded stores retrain through the shard-local rehash path,
    bit-identical self-matches included."""
    lsh = LSHRS(dim=32, backend="device", store_vectors=True, shards=4,
                num_perm=16, num_bands=4, rows_per_band=4,
                chunk_size=128, initial_capacity=512)
    X = _lowrank_data(rng, 300, 32)
    lsh.index(list(range(300)), X)
    lsh.retrain(iters=8)
    idx, count = lsh._ordered_candidates(X[9])[0]
    assert idx == 9 and count == 4


def test_sample_payload_rows(rng):
    """Device-side strided sampling: O(cap) readback feeding retrain."""
    lsh, X = _device_lsh(rng)
    store = lsh._storage
    rows = store.sample_payload_rows(10_000)  # cap above n: all alive rows
    assert rows.shape == X.shape and rows.dtype == np.float32
    np.testing.assert_allclose(rows, X, rtol=1e-6)
    capped = store.sample_payload_rows(64)
    assert capped.shape == (64, 32)
    # strided subsample: every returned row is a stored row
    assert all(
        np.isclose(X, r[None, :], atol=1e-6).all(axis=1).any() for r in capped
    )
    lsh.delete([0, 1, 2])
    alive = store.sample_payload_rows(10_000)
    assert alive.shape[0] == X.shape[0] - 3  # tombstones excluded
    with pytest.raises(ValueError, match="cap must be > 0"):
        store.sample_payload_rows(0)


def test_sample_payload_rows_int8_dequantized(rng):
    lsh, X = _device_lsh(rng, payload_dtype="int8")
    rows = lsh._storage.sample_payload_rows(10_000)
    # int8 rows come back dequantized by the per-row scale
    np.testing.assert_allclose(rows, X, rtol=0.05, atol=0.02)
    info = lsh.retrain(iters=4)  # default sample path rides the sampler
    assert info["sample_rows"] == X.shape[0]


def test_sample_payload_rows_requires_payload(rng):
    lsh = LSHRS(dim=16, backend="device", store_vectors=False, num_perm=16,
                num_bands=4, rows_per_band=4, chunk_size=64,
                initial_capacity=64)
    lsh.ingest(1, rng.standard_normal(16).astype(np.float32))
    lsh.flush()
    with pytest.raises(RuntimeError, match="store_vectors=True"):
        lsh._storage.sample_payload_rows(8)
