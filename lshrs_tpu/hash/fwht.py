"""Structured (Fast Walsh-Hadamard) LSH projections.

The reference's hyperplane LSH multiplies every vector by a dense
``(num_perm, dim)`` Gaussian matrix (`/root/reference/lshrs/hash/lsh.py:18`,
per-band GEMVs).  On a serving host that sgemm *is* the ingest/query hash
bottleneck: at dim=768, num_perm=256 it costs ~393 Kflop per vector and the
measured host rate pins the machine's sgemm peak.  The structured family
replaces the Gaussian matrix with pseudo-random rotations

    y = H D3 H D2 H D1 x_pad

(``D_i`` seeded random +-1 diagonals, ``H`` the unnormalised Walsh-Hadamard
transform on ``dpad = next_pow2(dim)`` coordinates); hash bits are the signs
of the first ``num_perm`` rotated coordinates (additional independent
rotation blocks cover ``num_perm > dpad``).  Three HD layers are the
standard recipe (FALCONN-style pseudo-random rotations; Andoni et al. 2015)
for making the rotation behave like a uniformly random one — for any fixed
query/corpus pair the per-bit collision probability matches the Gaussian
family's ``1 - angle/pi`` and banded AND-OR amplification applies unchanged.
Cost: ``3 dpad log2(dpad)`` adds + ``3 dpad`` multiplies per vector — ~13x
fewer flops than the sgemm at the flagship shape, and L1-resident in the C
implementation (`lshrs_tpu/native/fwht.c`).

Bit-parity contract: the NumPy, JAX and C implementations perform the
butterfly passes in the *same* order (h = 1, 2, ..., dpad/2), so their
float32 outputs — and therefore the hash bits — are bit-identical on every
backend.  Addition order is the only degree of freedom in FWHT; fixing it
makes the transform deterministic across hosts and devices, which is what
lets one store accept host- and device-hashed queries interchangeably
(stronger than the Gaussian family, where host sgemm vs device matmul
round differently and path consistency per store is required).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "next_pow2",
    "structured_diags",
    "structured_coords_np",
    "structured_coords_jax",
    "fwht_np",
    "fwht_jax",
    "MAX_DPAD",
]

MAX_DPAD = 8192  # keep one vector's buffer L1/L2-resident in the C path


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 2)."""
    return 1 << max(1, (int(n) - 1).bit_length())


def structured_diags(seed: int, *, dim: int, num_perm: int) -> np.ndarray:
    """Seeded +-1 diagonals, ``(nblocks, 3, dpad)`` float32.

    ``dpad = next_pow2(dim)``; ``nblocks = ceil(num_perm / dpad)``
    independent rotation blocks cover signatures wider than one rotation.
    """
    dpad = next_pow2(dim)
    if dpad > MAX_DPAD:
        raise ValueError(
            f"structured hash supports dim <= {MAX_DPAD}; got dim={dim}"
        )
    nblocks = -(-num_perm // dpad)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(nblocks, 3, dpad), dtype=np.int8)
    return (bits.astype(np.float32) * 2.0 - 1.0)


def fwht_np(y: np.ndarray) -> np.ndarray:
    """Unnormalised FWHT over the last axis of ``(n, d)``, d a power of 2.

    Pass order h = 1, 2, ..., d/2; within a pass pair (t, t+h) maps to
    (a+b, a-b).  This order is normative — see module docstring.
    """
    n, d = y.shape
    h = 1
    while h < d:
        y3 = y.reshape(n, d // (2 * h), 2, h)
        a = y3[:, :, 0, :]
        b = y3[:, :, 1, :]
        y = np.stack((a + b, a - b), axis=2).reshape(n, d)
        h *= 2
    return y


def fwht_jax(y):
    """JAX twin of :func:`fwht_np` — identical pass/association order."""
    import jax.numpy as jnp

    n, d = y.shape
    h = 1
    while h < d:
        y3 = y.reshape(n, d // (2 * h), 2, h)
        a = y3[:, :, 0, :]
        b = y3[:, :, 1, :]
        y = jnp.stack((a + b, a - b), axis=2).reshape(n, d)
        h *= 2
    return y


def _structured_coords(x, diags, num_perm: int, fwht, xp):
    n, dim = x.shape
    nblocks, _, dpad = diags.shape
    outs = []
    produced = 0
    for blk in range(nblocks):
        if produced >= num_perm:
            break
        z = x * diags[blk, 0, :dim][None, :]
        if dpad != dim:
            z = xp.pad(z, ((0, 0), (0, dpad - dim)))
        z = fwht(z)
        z = fwht(z * diags[blk, 1][None, :])
        z = fwht(z * diags[blk, 2][None, :])
        take = min(num_perm - produced, dpad)
        outs.append(z[:, :take])
        produced += take
    return xp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]


def structured_coords_np(
    x: np.ndarray, diags: np.ndarray, num_perm: int
) -> np.ndarray:
    """Rotated coordinates ``(n, num_perm)`` float32 — C path when the
    native library loads (bit-identical, ~L1-resident), NumPy otherwise."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, dim = x.shape
    nblocks, _, dpad = diags.shape
    from lshrs_tpu.native.build import load_fwht_library

    lib = load_fwht_library()
    if lib is not None:
        out = np.empty((n, num_perm), dtype=np.float32)
        d = np.ascontiguousarray(diags, dtype=np.float32)
        rc = lib.fwht_structured(
            x.ctypes.data, n, dim, d.ctypes.data, nblocks, dpad, num_perm,
            out.ctypes.data,
        )
        if rc == 0:
            return out
    return _structured_coords(x, diags, num_perm, fwht_np, np)


def structured_coords_jax(x, diags, num_perm: int):
    """JAX twin of :func:`structured_coords_np` (same association order)."""
    import jax.numpy as jnp

    return _structured_coords(x, jnp.asarray(diags), num_perm, fwht_jax, jnp)
