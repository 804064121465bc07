"""Band/row auto-tuning for the cross-polytope hash family.

The sign-bit tuner (`lshrs_tpu.utils.br`) builds on the closed form
``p_band(s) = s**r`` — the probability that all ``r`` hyperplane signs
agree, where ``s`` is the reference's "similarity" parametrisation of the
angle. A cross-polytope band has no such closed form: its collision
probability is

    p_cp(s, d) = P[ signed-argmax_d(R u) == signed-argmax_d(R v) ],

the probability that two jointly-Gaussian rotated coordinate vectors with
per-coordinate correlation ``rho = cos(theta) = cos(pi * (1 - s))`` share
their largest-|coordinate| signed axis among ``d = cp_dims`` coordinates.
(The ``s -> angle`` map matches the sign family's convention, so a CP
config tuned for threshold ``t`` targets the same geometric operating
point as a sign config tuned for ``t`` — the reference parametrises
``s = 1 - angle/pi``, `/root/reference/lshrs/utils/br.py:81`.)

This module estimates ``p_cp`` by seeded Monte Carlo on a similarity grid
(vectorised NumPy; cached per ``cp_dims``), plugs it into the same banded
S-curve ``P(s) = 1 - (1 - p_cp(s)) ** b`` and the same uniform FP/FN mass
integrals as `lshrs_tpu.utils.br.compute_false_rates`, and picks the
``(num_bands, rows_per_band)`` factorisation of ``num_perm`` minimising
``FP + FN`` — where ``rows_per_band = r`` means ``cp_dims = 2^(r-1)``
rotated coordinates, i.e. ``2^r`` bucket symbols per band (the same key
width and bucket count as an ``r``-bit sign band; see
`lshrs_tpu.hash.crosspolytope.cp_dims_for`).

Pure host-side math: it runs once at index construction. The MC curves are
deterministic (fixed seed) so a given (num_perm, threshold, dim) always
tunes to the same banding — reproducibility matches the reference tuner.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from lshrs_tpu.hash.crosspolytope import cp_dims_for
from lshrs_tpu.hash.fwht import next_pow2

__all__ = [
    "cp_collision_probability",
    "cp_band_collision_curve",
    "compute_cp_false_rates",
    "find_optimal_cp_br",
    "get_optimal_cp_config",
]

# Similarity grid for the MC curve + Simpson integration (must be even
# intervals for Simpson; 64 intervals keeps the integration error well
# under the MC noise floor).
_N_GRID = 65
_MC_SAMPLES = 4096
_MC_SEED = 0x5EED


@lru_cache(maxsize=16)
def cp_band_collision_curve(cp_dims: int) -> tuple[np.ndarray, np.ndarray]:
    """Monte-Carlo per-band collision curve for ``cp_dims`` coordinates.

    Returns ``(s_grid, p_grid)`` with ``s_grid`` the ``_N_GRID`` uniform
    similarities in [0, 1] and ``p_grid[i] ~= p_cp(s_grid[i], cp_dims)``.
    Deterministic (seeded); ~4k samples put the per-point standard error
    under 0.008, far below banding-choice sensitivity.
    """
    if cp_dims < 1:
        raise ValueError("cp_dims must be >= 1")
    s_grid = np.linspace(0.0, 1.0, _N_GRID)
    rng = np.random.default_rng(_MC_SEED + cp_dims)
    z = rng.standard_normal((_MC_SAMPLES, cp_dims))
    z2 = rng.standard_normal((_MC_SAMPLES, cp_dims))

    def signed_argmax(y: np.ndarray) -> np.ndarray:
        i = np.argmax(np.abs(y), axis=1)
        v = y[np.arange(y.shape[0]), i]
        return 2 * i + (v < 0)

    sym_u = signed_argmax(z)
    p_grid = np.empty(_N_GRID)
    for k, s in enumerate(s_grid):
        # Two unit vectors at reference-similarity s subtend angle
        # pi*(1-s); their rotated coordinates are jointly Gaussian with
        # correlation rho = cos(pi*(1-s)).
        rho = float(np.cos(np.pi * (1.0 - s)))
        w = rho * z + np.sqrt(max(0.0, 1.0 - rho * rho)) * z2
        p_grid[k] = float(np.mean(signed_argmax(w) == sym_u))
    # Endpoints are exact: identical vectors always collide; antipodal
    # vectors (rho = -1) get the mirrored symbol, never the same one.
    p_grid[-1] = 1.0
    p_grid[0] = 0.0
    return s_grid, p_grid


def cp_collision_probability(
    similarity: float, cp_dims: int, num_bands: int = 1
) -> float:
    """Banded CP collision probability ``1 - (1 - p_cp(s))**b``.

    The CP analogue of `lshrs_tpu.utils.br.compute_collision_probability`;
    linear interpolation on the cached MC curve.
    """
    if not 0.0 <= similarity <= 1.0:
        raise ValueError("similarity must be within [0, 1]")
    if num_bands < 1:
        raise ValueError("num_bands must be >= 1")
    s_grid, p_grid = cp_band_collision_curve(cp_dims)
    p = float(np.interp(similarity, s_grid, p_grid))
    return 1.0 - (1.0 - p) ** num_bands


def _simpson(y: np.ndarray, x: np.ndarray) -> float:
    """Composite Simpson over a uniform, odd-length grid."""
    h = x[1] - x[0]
    return float(
        (h / 3.0)
        * (y[0] + y[-1] + 4.0 * y[1:-1:2].sum() + 2.0 * y[2:-2:2].sum())
    )


def compute_cp_false_rates(
    num_bands: int, rows_per_band: int, threshold: float
) -> tuple[float, float]:
    """Uniform FP/FN probability mass of a CP banding at a threshold.

    Mirrors `lshrs_tpu.utils.br.compute_false_rates`: FP is the S-curve's
    mass on [0, t] (pairs below threshold that still collide), FN the
    complement's mass on [t, 1] — both under the uniform measure on s, so
    sign and CP configs are scored on the same scale.
    """
    if not 0.0 < threshold < 1.0:
        raise ValueError("threshold must be within (0, 1)")
    s_grid, p_grid = cp_band_collision_curve(cp_dims_for(rows_per_band))
    curve = 1.0 - (1.0 - p_grid) ** num_bands
    # Integrate on sub-grids re-sampled to odd length over [0,t] and [t,1].
    xs_lo = np.linspace(0.0, threshold, _N_GRID)
    xs_hi = np.linspace(threshold, 1.0, _N_GRID)
    fp = _simpson(np.interp(xs_lo, s_grid, curve), xs_lo)
    fn = _simpson(1.0 - np.interp(xs_hi, s_grid, curve), xs_hi)
    return fp, fn


def find_optimal_cp_br(
    num_perm: int, threshold: float, dim: int
) -> tuple[int, int, float, float] | None:
    """Best CP factorisation of ``num_perm`` for a threshold, or None.

    Enumerates every divisor split ``b * r == num_perm`` with
    ``2 <= r`` and ``cp_dims = 2^(r-1) <= next_pow2(dim)`` (the family's
    geometric feasibility bound, `lshrs_tpu.hash.crosspolytope
    .validate_cp_geometry`), scores each by FP + FN mass, and returns
    ``(num_bands, rows_per_band, fp, fn)`` for the minimum.

    Unlike the sign-family search there is no threshold-window pre-filter:
    the feasible ``r`` range is tiny (at most ~13 values), so scoring all
    of them is cheaper than estimating each configuration's implied
    threshold first.
    """
    if num_perm <= 0:
        raise ValueError("num_perm must be positive")
    if not 0.0 < threshold < 1.0:
        raise ValueError("threshold must be within (0, 1)")
    dpad = next_pow2(dim)
    best: tuple[int, int, float, float] | None = None
    for r in range(2, num_perm + 1):
        if num_perm % r:
            continue
        if cp_dims_for(r) > dpad:
            break  # r only grows from here
        b = num_perm // r
        fp, fn = compute_cp_false_rates(b, r, threshold)
        if best is None or fp + fn < best[2] + best[3]:
            best = (b, r, fp, fn)
    return best


@lru_cache(maxsize=64)
def get_optimal_cp_config(
    num_perm: int, threshold: float, dim: int
) -> tuple[int, int]:
    """``(num_bands, rows_per_band)`` for the cross-polytope family.

    The CP counterpart of `lshrs_tpu.utils.br.get_optimal_config` (called
    by the `LSHRS` constructor when ``hash_family='crosspolytope'`` and
    the banding is left to auto-config). Raises when no divisor of
    ``num_perm`` is feasible at this ``dim`` (only possible when
    ``num_perm`` is prime or ``dim`` is tiny) — pass the banding
    explicitly in that case.

    Cost (measured, 1-core host): ~0.5 s on the first-ever call in a
    process (seeds the shared per-``cp_dims`` MC curves) and ~0.1 ms
    thereafter — the curves are keyed by ``cp_dims``, not ``num_perm``,
    so even a cold call at a new ``num_perm`` reuses them; this cache
    makes repeat constructions free outright.
    """
    best = find_optimal_cp_br(num_perm, threshold, dim)
    if best is not None:
        return best[0], best[1]
    raise ValueError(
        f"no cross-polytope banding divides num_perm={num_perm} with "
        f"rows_per_band >= 2 and cp_dims <= next_pow2(dim)={next_pow2(dim)}; "
        "pass num_bands and rows_per_band explicitly"
    )
