"""Fused score -> selection key -> group-max kernels (Pallas, Triton route).

Every grouped engine ends its scan the same way: score each (query, slot)
pair, pack ``(score, tie)`` into one int32 selection key, and keep only
the maximum key of each contiguous ``group``-slot run. The plain XLA
formulation of that pipeline writes the ``(Q, chunk)`` score block to
device memory and reads it back for the key and the group-max; a kernel
keeps it in registers and writes only the ``(Q, C / group)`` group maxima.

The group maxima feed an *exact* two-stage top-k on the XLA side (see
`lshrs_tpu.ops.scan.collision_topk_grouped`): because every slot's key is
globally unique (the tie term embeds the slot's id-rank), the top-k groups
by max provably contain every true top-k slot, so refining only those
groups is exact. Groups are contiguous slot runs, so the refine tables
(`lshrs_tpu.ops.scan.build_grouped_refine_rows`) have one geometry.

Kernels are written for the GPU's block model: a fully parallel grid of
``(query tile, slot tile)`` blocks with no state carried between blocks,
power-of-two tiles, and the query-tile axis innermost so that the blocks
in flight share one store tile and the queries stay in L2. They run
compiled through Triton on a GPU (``kernel="triton"``) and in Pallas'
interpreter on the CPU (``kernel="interpret"``, tests only); callers pick
the route with :func:`scan_kernel`.

Key packing requires ``(num_bands + 1) * S < 2**31`` with
``S = next_pow2(C)``; stores that exceed this fall back to the chunked
exact scan in `lshrs_tpu.ops.scan`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = [
    "KERNEL_MODES",
    "collision_group_max_keys",
    "dot_group_max_keys",
    "key_scale",
    "scan_kernel",
    "supports_fast_path",
]

# ``kernel=`` values: None runs the plain XLA formulation, "triton" the
# compiled GPU kernel, "interpret" the same kernel in Pallas' interpreter.
KERNEL_MODES = (None, "triton", "interpret")

# Tiles: a (64, 256) int32 key block is 128 registers a thread at four
# warps; the int8 operands of a 256-bit dot are 80 KB of shared memory.
BLOCK_Q = 64
BLOCK_C = 256
_NUM_WARPS = 4


def key_scale(capacity: int) -> int:
    """S — the multiplier separating count from tie bits in packed keys."""
    return 1 << max(1, (capacity - 1).bit_length())


def supports_fast_path(num_bands: int, capacity: int) -> bool:
    """True when (count, tie) packs into a positive int32."""
    return (num_bands + 1) * key_scale(capacity) < 2**31


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def scan_kernel(
    capacity: int, group: int, *, width: int = 16, platform: str | None = None
) -> str | None:
    """The group-max route for a store: ``"triton"`` on a GPU, else None.

    ``width`` is the kernel's contracted operand width (bitplane bits for
    the dot kernel); Triton tiles must be powers of two, and its dot needs
    every operand dimension >= 16. A store the kernel cannot tile (or any
    non-GPU platform) takes the plain XLA formulation; the choice is
    reported by ``DeviceStore.stats()["scan_kernel"]``.
    """
    platform = platform or jax.default_backend()
    if platform != "gpu":
        return None
    ok = (
        _pow2(capacity)
        and _pow2(group)
        and _pow2(width)
        and width >= 16
        and capacity >= max(16, group)
    )
    return "triton" if ok else None


def _block_c(c: int, group: int) -> int:
    return min(c, max(BLOCK_C, group))


def _grouped_call(kernel, q_op, store_op, bias, *, store_t, group, mode, cost):
    """Run a group-max kernel over a (query tile, slot tile) grid.

    ``q_op``: ``(Q, K)`` query operand, padded here to the query tile and
    sliced back. ``store_op``: ``(C, K)`` (``store_t=False``) or the
    transposed ``(K, C)`` (``store_t=True``). ``bias``: ``(C,)`` int32.
    Returns ``(Q, C // group)`` int32.
    """
    if mode not in KERNEL_MODES[1:]:
        raise ValueError(f"kernel must be 'triton' or 'interpret', got {mode!r}")
    q, kq = q_op.shape
    c = store_op.shape[1] if store_t else store_op.shape[0]
    kc = store_op.shape[0] if store_t else store_op.shape[1]
    bc = _block_c(c, group)
    bq = min(BLOCK_Q, 1 << max(4, (q - 1).bit_length()))
    q_pad = -(-q // bq) * bq
    if q_pad != q:
        q_op = jnp.pad(q_op, ((0, q_pad - q), (0, 0)))
    if store_t:
        store_spec = pl.BlockSpec((kc, bc), lambda i, j: (0, j))
    else:
        store_spec = pl.BlockSpec((bc, kc), lambda i, j: (j, 0))
    out = pl.pallas_call(
        kernel,
        # Query tiles innermost: consecutive blocks read the same store
        # tile, so the store streams from device memory about once.
        grid=(q_pad // bq, c // bc),
        in_specs=[
            pl.BlockSpec((bq, kq), lambda i, j: (i, 0)),
            store_spec,
            pl.BlockSpec((bc,), lambda i, j: (j,)),
        ],
        out_specs=pl.BlockSpec((bq, bc // group), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((q_pad, c // group), jnp.int32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=2),
        cost_estimate=pl.CostEstimate(
            flops=cost, transcendentals=0,
            bytes_accessed=int(
                store_op.size * store_op.dtype.itemsize
                + q_pad * kq * q_op.dtype.itemsize + c * 4
                + q_pad * (c // group) * 4
            ),
        ),
        interpret=mode == "interpret",
        name="group_max_keys",
    )(q_op, store_op, bias)
    return out[:q] if q_pad != q else out


def _group_max(key: jax.Array, group: int) -> jax.Array:
    """Max over contiguous ``group``-slot runs of a ``(Q, C)`` key block."""
    q, c = key.shape
    return key.reshape(q, c // group, group).max(axis=-1)


# ---------------------------------------------------------------------------
# dot kernel: int8 bitplanes (Hamming, cascade coarse pass, asymmetric)
# ---------------------------------------------------------------------------


def _dot_kernel(q_ref, planes_ref, bias_ref, out_ref, *, group, scale, offset, shift):
    dots = pl.dot(q_ref[...], planes_ref[...], trans_b=True)  # int32 (bq, bc)
    key = ((dots + offset) >> shift) * scale + bias_ref[...][None, :]
    out_ref[...] = _group_max(key, group)


def _dot_key_bias(tie: jax.Array, *, scale: int, maxscaled: int) -> jax.Array:
    """Per-slot key bias for the dot ranking: ``tie + scale`` for alive
    slots, ``-maxscaled * scale`` for dead ones.

    ``maxscaled`` is the largest value the scaled-dot term can take —
    ``num_perm`` for symmetric Hamming, generally ``(2*offset) >> shift``
    — so every dead key is ``<= 0`` and every alive key ``>= scale``.
    """
    return jnp.where(tie >= 0, tie + scale, -maxscaled * scale)


@partial(
    jax.jit,
    static_argnames=("group", "chunk", "scale", "offset", "shift", "kernel"),
)
def dot_group_max_keys(
    planes: jax.Array,
    tie: jax.Array,
    qbits: jax.Array,
    *,
    group: int,
    chunk: int,
    scale: int,
    offset: int | None = None,
    shift: int = 1,
    kernel: str | None = None,
) -> jax.Array:
    """Per-group maxima of ``((dots + offset) >> shift) * scale + bias``.

    Args:
        planes: ``(C, P)`` int8 ±1 store bitplanes.
        tie: ``(C,)`` int32 tie keys (-1 dead).
        qbits: ``(Q, P)`` int8 query operand: ±1 bitplanes (symmetric
            Hamming, ``offset=None`` meaning ``P``, ``shift=1``) or
            quantised coordinates in ``[-qmax, qmax]`` (asymmetric
            ranking, ``offset = P * qmax``).
        chunk: slot chunk of the XLA formulation's ``lax.scan``.
        kernel: see :data:`KERNEL_MODES`.

    For alive slots the key is ``((dots+P)>>1 + 1) * scale + tie`` in the
    symmetric case — lexicographic (similarity, tie), globally distinct.
    Dead slots score ``<= 0``, below every alive key, whatever their stale
    bitplanes hold. ``|key| <= (maxscaled + 2) * scale``.

    Returns:
        ``(Q, C // group)`` int32; group ``g`` is slots
        ``[g * group, (g + 1) * group)``.
    """
    c, p = planes.shape
    q = qbits.shape[0]
    off = p if offset is None else offset
    bias = _dot_key_bias(tie, scale=scale, maxscaled=(2 * off) >> shift)
    if kernel is not None:
        body = partial(_dot_kernel, group=group, scale=scale, offset=off, shift=shift)
        return _grouped_call(
            body, qbits, planes, bias, store_t=False, group=group, mode=kernel,
            cost=2 * q * c * p,
        )
    nchunks = c // chunk

    def step(carry, xs):
        chunk_planes, chunk_bias = xs
        dots = jax.lax.dot_general(
            qbits,
            chunk_planes,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        key = ((dots + off) >> shift) * scale + chunk_bias[None, :]
        return carry, _group_max(key, group)

    _, gmax = jax.lax.scan(
        step, 0, (planes.reshape(nchunks, chunk, p), bias.reshape(nchunks, chunk))
    )
    return jnp.moveaxis(gmax, 0, 1).reshape(q, c // group)


# ---------------------------------------------------------------------------
# collision kernel: per-band word equality over the transposed store
# ---------------------------------------------------------------------------


def _collision_kernel(
    q_ref, sig_ref, bias_ref, out_ref, *, num_bands, words, group, scale, probes
):
    bw = num_bands * words
    counts = None
    for t in range(probes):
        for b in range(num_bands):
            col = t * bw + b * words
            eq = sig_ref[b * words, :][None, :] == q_ref[:, col][:, None]
            for w in range(1, words):
                eq &= sig_ref[b * words + w, :][None, :] == q_ref[:, col + w][:, None]
            counts = eq.astype(jnp.int32) if counts is None else counts + eq
    key = counts * scale + bias_ref[...][None, :]
    out_ref[...] = _group_max(key, group)


@partial(
    jax.jit,
    static_argnames=("num_bands", "words", "group", "scale", "probes", "kernel"),
)
def collision_group_max_keys(
    sig_t: jax.Array,
    tie: jax.Array,
    qwords: jax.Array,
    *,
    num_bands: int,
    words: int,
    group: int,
    scale: int,
    probes: int = 1,
    kernel: str | None = None,
) -> jax.Array:
    """Per-group maxima of packed ``(count, tie)`` collision keys.

    Args:
        sig_t: ``(num_bands * words, C)`` uint32 transposed signatures.
        tie: ``(C,)`` int32 — ``S - 1 - rank`` alive, ``-1`` dead.
        qwords: ``(Q, probes * num_bands * words)`` uint32, probe-major.
        kernel: see :data:`KERNEL_MODES`.

    Alive key ``count * scale + tie``; dead key ``(count - B) * scale <= 0``.
    ``count`` is the number of bands matching any probe variant
    (`lshrs_tpu.ops.scan.band_counts_t`).
    """
    bw, c = sig_t.shape
    q = qwords.shape[0]
    bias = jnp.where(tie >= 0, tie, -num_bands * scale)
    if kernel is None:
        from lshrs_tpu.ops.scan import band_counts_t

        counts = band_counts_t(sig_t, qwords, num_bands, probes)
        return _group_max(counts * scale + bias[None, :], group)
    body = partial(
        _collision_kernel, num_bands=num_bands, words=words, group=group,
        scale=scale, probes=probes,
    )
    return _grouped_call(
        body, qwords, sig_t, bias, store_t=True, group=group, mode=kernel,
        cost=2 * q * c * bw * probes,
    )
