"""Shared fixtures: hermetic backends, small-index factories, fake devices.

Tests run on the JAX CPU backend with 8 virtual devices so sharding tests
exercise real `jax.sharding` machinery without accelerator hardware; all
storage is in-process (MemoryStorage bucket dict or the device signature
store on CPU). Tests marked ``gpu`` skip here and run on the card with
``LSHRS_TEST_PLATFORM=cuda python -m pytest -m gpu tests/``.
"""

from __future__ import annotations

import os

# Must be set before jax initialises its backends. Tests are hermetic and
# run on CPU with 8 virtual devices unless LSHRS_TEST_PLATFORM names
# another platform; jax.config is set as well as JAX_PLATFORMS.
_platform = os.environ.get("LSHRS_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", _platform)

import numpy as np
import pytest

from lshrs_tpu import LSHRS
from lshrs_tpu.storage.memory import MemoryStorage

# The hermetic bucket fake used across orchestrator tests (the reference's
# MockStorage analogue) *is* the in-memory backend: it records batches,
# op counts, and supports fail_on_flush fault injection.
MockStorage = MemoryStorage


@pytest.fixture
def mock_storage() -> MemoryStorage:
    return MemoryStorage()


@pytest.fixture
def make_lsh(mock_storage: MemoryStorage):
    """Factory: LSHRS over the bucket-dict fake with small test defaults."""

    def _make(
        dim: int = 32,
        num_bands: int = 4,
        rows_per_band: int = 4,
        num_perm: int = 16,
        buffer_size: int = 10_000,
        seed: int = 42,
        vector_fetch_fn=None,
        storage=None,
    ) -> LSHRS:
        return LSHRS(
            dim=dim,
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            num_perm=num_perm,
            buffer_size=buffer_size,
            seed=seed,
            vector_fetch_fn=vector_fetch_fn,
            storage=storage or mock_storage,
        )

    return _make


@pytest.fixture
def make_device_lsh():
    """Factory: LSHRS over the device signature store (CPU-backed in tests)."""

    def _make(
        dim: int = 32,
        num_bands: int = 4,
        rows_per_band: int = 4,
        num_perm: int = 16,
        buffer_size: int = 10_000,
        seed: int = 42,
        vector_fetch_fn=None,
        store_vectors: bool = False,
        **kwargs,
    ) -> LSHRS:
        return LSHRS(
            dim=dim,
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            num_perm=num_perm,
            buffer_size=buffer_size,
            seed=seed,
            vector_fetch_fn=vector_fetch_fn,
            backend="device",
            store_vectors=store_vectors,
            chunk_size=128,
            initial_capacity=128,
            **kwargs,
        )

    return _make


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(12345)
