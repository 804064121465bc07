"""lshrs_tpu — accelerator-resident banded random-projection LSH index & query engine.

A brand-new JAX/XLA/Pallas implementation of the capability set of the
``lshrs`` library (Redis-backed LSH for approximate nearest-neighbor
search): batched matmul signature hashing, a device-resident signature store
with fused collision-count/top-k query kernels, cosine reranking against a
device-resident payload, streaming ingestion, band/row auto-tuning,
persistence, and mesh-sharded scale-out.
"""

import importlib.metadata
from typing import Final

from lshrs_tpu.core.main import LSHRS, lshrs
from lshrs_tpu.storage import BaseStorage, DeviceStore, IdFilter, MemoryStorage

# Version from installed package metadata (single source of truth:
# pyproject.toml), with a development-checkout fallback — the reference's
# contract (/root/reference/lshrs/__init__.py:6-10).
try:
    _version = importlib.metadata.version("lshrs-tpu")
except importlib.metadata.PackageNotFoundError:  # pragma: no cover
    _version = "0.0.0"  # development mode (not pip-installed)
__version__: Final[str] = _version
del _version

# Fail fast when hard dependencies are missing.
_hard_dependencies = ("numpy", "jax")
for _dependency in _hard_dependencies:
    try:
        __import__(_dependency)
    except ImportError as _e:  # pragma: no cover
        raise ImportError(
            f"Unable to import required dependency {_dependency}. "
            "Please see the traceback for details."
        ) from _e
del _hard_dependencies, _dependency

__all__ = [
    "LSHRS",
    "lshrs",
    "BaseStorage",
    "DeviceStore",
    "IdFilter",
    "MemoryStorage",
    "__version__",
]
