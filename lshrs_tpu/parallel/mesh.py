"""Device-mesh construction helpers.

The index's single scale axis is *slots* (vector count x signature width);
it shards as data parallelism over a 1-D mesh. Queries are replicated,
shard-local top-k lists merge over the interconnect with one all-gather (see
`lshrs_tpu.parallel.sharded`), so the collective payload per query is
``O(nshards * k)`` ints — independent of index size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

SHARD_AXIS = "shard"

__all__ = ["SHARD_AXIS", "make_mesh"]


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_name: str = SHARD_AXIS,
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devices)} available"
            )
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), axis_names=(axis_name,))
