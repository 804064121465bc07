"""Persistence: save/load round-trips, password redaction, pickle."""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest

from lshrs_tpu import LSHRS


def test_save_load_roundtrip_config_and_projections(tmp_path, make_device_lsh, rng):
    lsh = make_device_lsh(dim=16, num_bands=2, rows_per_band=4, num_perm=8, seed=9)
    X = rng.standard_normal((20, 16)).astype(np.float32)
    lsh.index(list(range(20)), X)
    lsh.save_to_disk(tmp_path / "model")

    restored = LSHRS.load_from_disk(tmp_path / "model")
    stats_a, stats_b = lsh.stats(), restored.stats()
    for key in ("dimension", "num_perm", "num_bands", "rows_per_band", "buffer_size"):
        assert stats_a[key] == stats_b[key]

    # exact projection arrays
    for a, b in zip(lsh._hasher.projections, restored._hasher.projections):
        np.testing.assert_array_equal(a, b)

    # device index contents restored too (new capability vs reference)
    q = rng.standard_normal(16).astype(np.float32)
    assert lsh.query(q, top_k=None) == restored.query(q, top_k=None)


def test_password_redacted_in_metadata(tmp_path):
    lsh = LSHRS(
        dim=8,
        num_perm=4,
        num_bands=2,
        rows_per_band=2,
        backend="memory",
        redis_password="hunter2",
    )
    lsh.save_to_disk(tmp_path / "model")
    raw = (tmp_path / "model" / "metadata.json").read_text()
    assert "hunter2" not in raw
    meta = json.loads(raw)
    assert meta["redis_config"]["password"] == "<REDACTED>"


def test_load_password_override(tmp_path):
    lsh = LSHRS(
        dim=8, num_perm=4, num_bands=2, rows_per_band=2,
        backend="memory", redis_password="hunter2",
    )
    lsh.save_to_disk(tmp_path / "model")
    restored = LSHRS.load_from_disk(
        tmp_path / "model", redis_config={"password": "secret"}
    )
    assert restored._redis_config["password"] == "secret"


def test_load_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="Directory not found"):
        LSHRS.load_from_disk(tmp_path / "nope")


def test_load_missing_files_raises(tmp_path):
    (tmp_path / "partial").mkdir()
    with pytest.raises(FileNotFoundError):
        LSHRS.load_from_disk(tmp_path / "partial")


def test_pickle_roundtrip_device(make_device_lsh, rng):
    lsh = make_device_lsh(dim=16, num_bands=2, rows_per_band=4, num_perm=8, seed=3)
    X = rng.standard_normal((15, 16)).astype(np.float32)
    lsh.index(list(range(15)), X)

    clone = pickle.loads(pickle.dumps(lsh))
    for a, b in zip(lsh._hasher.projections, clone._hasher.projections):
        np.testing.assert_array_equal(a, b)
    q = rng.standard_normal(16).astype(np.float32)
    assert lsh.query(q, top_k=None) == clone.query(q, top_k=None)
    # fetch functions are not persisted
    assert clone._vector_fetch_fn is None


def test_pickle_keeps_unredacted_password():
    lsh = LSHRS(
        dim=8, num_perm=4, num_bands=2, rows_per_band=2,
        backend="memory", redis_password="hunter2",
    )
    state = lsh.__getstate__()
    assert state["redis_config"]["password"] == "hunter2"


def test_save_load_preserves_capabilities(tmp_path, rng):
    """enable_hamming + engine knobs round-trip (ref main.py:880-976 keeps
    the full constructor config; the device extensions must too)."""
    lsh = LSHRS(
        dim=16, num_perm=8, num_bands=2, rows_per_band=4,
        backend="device", chunk_size=128, initial_capacity=128,
        enable_hamming=True, group_size=16, dedupe=False,
        query_mode="bucket", bucket_cap=64,
    )
    X = rng.standard_normal((30, 16)).astype(np.float32)
    lsh.index(list(range(30)), X)
    ham_before = lsh.query_hamming(X[7], top_k=3)
    lsh.save_to_disk(tmp_path / "m")

    back = LSHRS.load_from_disk(tmp_path / "m")
    store = back._storage
    # bitplanes are lazy: capability restored, array materializes on use
    assert store.enable_hamming and store._planes is None
    assert store.query_mode == "bucket"
    assert store.bucket_cap == 64
    assert store.group == 16
    assert store.dedupe is False and store._slot_of is None
    # a Hamming query works after restore, with identical results
    assert back.query_hamming(X[7], top_k=3) == ham_before


def test_pickle_preserves_capabilities(rng):
    lsh = LSHRS(
        dim=16, num_perm=8, num_bands=2, rows_per_band=4,
        backend="device", chunk_size=128, initial_capacity=128,
        enable_hamming=True,
    )
    X = rng.standard_normal((20, 16)).astype(np.float32)
    lsh.index(list(range(20)), X)
    clone = pickle.loads(pickle.dumps(lsh))
    assert clone.query_hamming(X[3], top_k=2) == lsh.query_hamming(X[3], top_k=2)


def test_save_flushes_buffer(tmp_path, make_device_lsh, rng):
    lsh = make_device_lsh(dim=16, num_bands=2, rows_per_band=4, num_perm=8)
    lsh.ingest(0, rng.standard_normal(16).astype(np.float32))
    assert lsh.stats()["buffered_operations"] > 0
    lsh.save_to_disk(tmp_path / "model")
    assert lsh.stats()["buffered_operations"] == 0
    restored = LSHRS.load_from_disk(tmp_path / "model")
    assert restored.stats()["index"]["alive"] == 1
