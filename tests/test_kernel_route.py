"""The group-max kernel route: which platform gets the GPU kernel, how the
wrapper tiles and pads queries, and that the refine table's groups are the
kernel's groups. Kernels run in Pallas' interpreter here; the compiled
Triton kernels are checked by the ``gpu`` test below and by
``chip_smoke.py`` on the card."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lshrs_tpu.ops import pallas_scan as ps
from lshrs_tpu.ops.scan import build_grouped_refine_rows, compute_global_tie
from lshrs_tpu.storage.device import DeviceStore


@pytest.mark.parametrize(
    "platform,capacity,group,width,want",
    [
        ("gpu", 1 << 20, 64, 256, "triton"),
        ("gpu", 1 << 22, 64, 128, "triton"),
        ("cpu", 1 << 20, 64, 256, None),
        ("gpu", 1 << 20, 64, 384, None),  # Triton tiles are powers of two
        ("gpu", 1 << 20, 64, 8, None),  # its dot needs every dim >= 16
        ("gpu", 3 << 10, 64, 256, None),
        ("gpu", 32, 64, 256, None),  # a group wider than the store
    ],
)
def test_scan_kernel_route(platform, capacity, group, width, want):
    assert ps.scan_kernel(capacity, group, width=width, platform=platform) == want


def test_scan_kernel_defaults_to_this_backend():
    assert ps.scan_kernel(1 << 20, 64, width=256) is None  # tests run on CPU


@pytest.mark.parametrize("mode", [None, "xla", "TRITON"])
def test_group_max_call_rejects_unknown_route(mode):
    with pytest.raises(ValueError, match="kernel must be"):
        ps._grouped_call(
            None, jnp.zeros((4, 16), jnp.int8), jnp.zeros((64, 16), jnp.int8),
            jnp.zeros((64,), jnp.int32), store_t=False, group=8, mode=mode, cost=0,
        )


@pytest.mark.parametrize(
    "storage,want", [("planes", "triton"), ("packed", "xla")]
)
def test_store_reports_route(monkeypatch, storage, want):
    """A store on a GPU serves collision and bitplane Hamming with the
    kernel and says so in stats(); packed Hamming stays on XLA."""
    import lshrs_tpu.storage.device as dev

    store = DeviceStore(
        num_bands=4, rows_per_band=8, chunk_size=128, initial_capacity=1024,
        enable_hamming=True, hamming_storage=storage,
    )
    assert store.stats()["scan_kernel"] == {"collision": "xla", "hamming": "xla"}
    real = dev.scan_kernel
    monkeypatch.setattr(
        dev, "scan_kernel",
        lambda c, g, width=16: real(c, g, width=width, platform="gpu"),
    )
    assert store.stats()["scan_kernel"] == {"collision": "triton", "hamming": want}


def _dot_operands(rng, c, p, q):
    ids = np.full(c, -1, np.int32)
    alive = rng.permutation(c)[: c * 3 // 4]
    ids[alive] = rng.permutation(10 * c)[: alive.size]
    planes = jnp.asarray(rng.choice([-1, 1], (c, p)).astype(np.int8))
    qb = jnp.asarray(rng.choice([-1, 1], (q, p)).astype(np.int8))
    return planes, compute_global_tie(jnp.asarray(ids)), qb, ids


@pytest.mark.parametrize("q", [1, 37, 64, 130])
def test_dot_kernel_pads_and_unpads_queries(rng, q):
    """Query counts off the 64-row tile are padded inside the wrapper and
    sliced back; every row equals the XLA formulation."""
    c, p, group = 512, 32, 16
    planes, tie, qb, _ = _dot_operands(rng, c, p, q)
    kw = dict(group=group, chunk=128, scale=ps.key_scale(c))
    got = ps.dot_group_max_keys(planes, tie, qb, kernel="interpret", **kw)
    assert got.shape == (q, c // group)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(ps.dot_group_max_keys(planes, tie, qb, **kw))
    )


@pytest.mark.parametrize("offset,shift", [(None, 1), (32 * 127, 0), (32 * 127, 3)])
def test_dot_kernel_key_packing(rng, offset, shift):
    """Symmetric Hamming and the asymmetric (offset, shift) packings: the
    kernel's keys equal the NumPy formula, group by contiguous group."""
    c, p, q, group = 256, 32, 8, 32
    planes, tie, _, _ = _dot_operands(rng, c, p, q)
    qv = rng.integers(-127, 128, (q, p)).astype(np.int8) if offset else (
        rng.choice([-1, 1], (q, p)).astype(np.int8)
    )
    scale = ps.key_scale(c)
    got = ps.dot_group_max_keys(
        planes, tie, jnp.asarray(qv), group=group, chunk=128, scale=scale,
        offset=offset, shift=shift, kernel="interpret",
    )
    off = p if offset is None else offset
    dots = qv.astype(np.int64) @ np.asarray(planes).astype(np.int64).T
    t = np.asarray(tie)
    bias = np.where(t >= 0, t + scale, -((2 * off) >> shift) * scale)
    key = ((dots + off) >> shift) * scale + bias[None, :]
    np.testing.assert_array_equal(
        np.asarray(got), key.reshape(q, c // group, group).max(axis=2)
    )


def test_refine_table_rows_are_kernel_groups(rng):
    """Row g of the grouped refine table holds exactly the slots whose keys
    the kernel folded into group maximum g (a mismatched table would gather
    the wrong slots)."""
    c, p, q, group = 512, 32, 4, 16
    planes, tie, qb, ids = _dot_operands(rng, c, p, q)
    gmax = np.asarray(ps.dot_group_max_keys(
        planes, tie, qb, group=group, chunk=128, scale=ps.key_scale(c),
        kernel="interpret",
    ))
    ext = jnp.concatenate(
        [
            jnp.zeros((c, 1), jnp.uint32),
            jax.lax.bitcast_convert_type(tie, jnp.uint32)[:, None],
            jax.lax.bitcast_convert_type(jnp.asarray(ids), jnp.uint32)[:, None],
        ],
        axis=1,
    )
    rows = np.asarray(build_grouped_refine_rows(ext, group=group))
    table_ids = rows.reshape(c // group, 3, group)[:, 2, :].view(np.int32)
    slot_of = {int(i): s for s, i in enumerate(ids) if i >= 0}
    dots = np.asarray(qb).astype(np.int64) @ np.asarray(planes).astype(np.int64).T
    scale, t = ps.key_scale(c), np.asarray(tie)
    for g in range(c // group):
        slots = [slot_of[int(i)] for i in table_ids[g] if i >= 0]
        if not slots:
            continue
        alive_key = ((dots[:, slots] + p) >> 1) * scale + t[slots] + scale
        np.testing.assert_array_equal(gmax[:, g], alive_key.max(axis=1))


@pytest.mark.gpu
def test_triton_kernels_match_xla_on_gpu(rng):
    """Compiled Triton kernels at serving widths equal the XLA formulation."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the Triton kernels compile only there")
    c, p, q, group = 1 << 16, 256, 300, 64
    planes, tie, qb, _ = _dot_operands(rng, c, p, q)
    kw = dict(group=group, chunk=2048, scale=ps.key_scale(c))
    np.testing.assert_array_equal(
        np.asarray(ps.dot_group_max_keys(planes, tie, qb, kernel="triton", **kw)),
        np.asarray(ps.dot_group_max_keys(planes, tie, qb, **kw)),
    )
    words = jnp.asarray(rng.integers(0, 4, (16, c)).astype(np.uint32))
    for probes in (1, 4):  # multi-probe widens the query block
        qw = jnp.asarray(rng.integers(0, 4, (q, 16 * probes)).astype(np.uint32))
        ckw = dict(num_bands=16, words=1, group=group, scale=ps.key_scale(c),
                   probes=probes)
        np.testing.assert_array_equal(
            np.asarray(ps.collision_group_max_keys(words, tie, qw, kernel="triton", **ckw)),
            np.asarray(ps.collision_group_max_keys(words, tie, qw, **ckw)),
        )
