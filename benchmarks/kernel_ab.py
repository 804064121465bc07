"""Group-max kernels against XLA's plain formulation, on one GPU.

    python benchmarks/kernel_ab.py --check   # compile + compare each kernel
    python benchmarks/kernel_ab.py           # end-to-end A/B through LSHRS

``--check`` compiles every Pallas kernel of `lshrs_tpu.ops.pallas_scan` at
the widths ``chip_smoke.py`` serves and compares its group maxima with the
plain XLA formulation bit for bit. The default A/B builds each serving
cell through ``LSHRS`` and times ``serving_fn`` with the store's kernel
choice forced to XLA and to the kernel, in turns (xla, kernel, kernel,
xla), in one process. Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

BATCH = cs.QUERY_BATCH
REPEATS = 5


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def _kernels():
    """(name, kernel fn, XLA fn, operand builder) for every kernel."""
    import jax
    import jax.numpy as jnp

    from lshrs_tpu.ops import pallas_scan as ps
    from lshrs_tpu.ops.scan import band_counts_t, compute_global_tie

    def operands(c, p, q, seed):
        k = jax.random.PRNGKey(seed)
        ids = jnp.where(
            jax.random.uniform(k, (c,)) < 0.9, jnp.arange(c, dtype=jnp.int32), -1
        )
        tie = compute_global_tie(ids)
        planes = jnp.where(jax.random.bernoulli(jax.random.fold_in(k, 1), 0.5, (c, p)), 1, -1).astype(jnp.int8)
        qb = jnp.where(jax.random.bernoulli(jax.random.fold_in(k, 2), 0.5, (q, p)), 1, -1).astype(jnp.int8)
        words = jax.random.bits(jax.random.fold_in(k, 3), (p // 32 * 2, c), jnp.uint32) & 3
        qw = jax.random.bits(jax.random.fold_in(k, 4), (q, p // 32 * 2), jnp.uint32) & 3
        return tie, planes, qb, words, qw

    cells = []
    for name, c, p, extra in (
        ("dot_hamming_1m", 1 << 20, 256, {}),
        ("dot_asymmetric_1m", 1 << 20, 256, {"offset": 256 * 127, "shift": 5}),
        ("dot_cascade_4m", 1 << 22, 128, {}),
    ):
        def make(c=c, p=p, extra=extra):
            tie, planes, qb, _, _ = operands(c, p, 256, 0)
            kw = dict(group=64, chunk=2048, scale=ps.key_scale(c), **extra)
            run = lambda kernel: ps.dot_group_max_keys(planes, tie, qb, kernel=kernel, **kw)
            return run
        cells.append((name, make))

    def make_collision(c=1 << 17):
        tie, _, _, words, qw = operands(c, 256, 256, 1)
        nb = words.shape[0]
        scale = ps.key_scale(c)

        def run(kernel):
            if kernel is None:
                counts = band_counts_t(words, qw, nb)
                key = counts * (tie >= 0)[None, :] * scale + jnp.maximum(tie, 0)[None, :]
                # dead slots: XLA keys 0, kernel keys <= 0 -> compare alive-masked
                return key.reshape(256, -1, 64).max(-1)
            return ps.collision_group_max_keys(
                words, tie, qw, num_bands=nb, words=1, group=64, scale=scale,
                kernel=kernel,
            )
        return run

    cells.append(("collision_128k", make_collision))
    return cells


def check_kernels() -> None:
    for name, make in _kernels():
        run = make()
        t0 = time.perf_counter()
        got = np.asarray(run("triton"))
        compile_s = time.perf_counter() - t0
        want = np.asarray(run(None))
        # Groups whose slots are all dead may differ (both are <= 0, below
        # every alive key); compare the groups that hold an alive slot.
        live = want > 0
        equal = bool(np.array_equal(got[live], want[live]) and (got[~live] <= 0).all())
        emit(cell=name, check="kernel_vs_xla", equal=equal, compile_s=compile_s,
             shape=list(got.shape))
        if not equal:
            raise SystemExit(f"{name}: kernel differs from XLA")
    collision_temp_bytes()


def collision_temp_bytes(q: int = BATCH, c: int = 1 << 17) -> None:
    """Scratch memory XLA plans for the collision query core at the smoke's
    shape, per route: does the plain version hold a (Q, C) count buffer?"""
    import jax
    import jax.numpy as jnp

    from lshrs_tpu.ops.pallas_scan import key_scale
    from lshrs_tpu.ops.scan import collision_topk_grouped_core

    args = (
        jax.ShapeDtypeStruct((16, c), jnp.uint32),
        jax.ShapeDtypeStruct((c,), jnp.int32),
        jax.ShapeDtypeStruct((c,), jnp.int32),
        jax.ShapeDtypeStruct((q, 16), jnp.uint32),
    )
    for kernel in (None, "triton"):
        fn = jax.jit(lambda s, i, t, w, kernel=kernel: collision_topk_grouped_core(
            s, i, t, w, num_bands=16, k=10, group=64, kernel=kernel))
        mem = fn.lower(*args).compile().memory_analysis()
        emit(cell="collision_128k", check="temp_bytes", kernel=kernel, q=q, c=c,
             temp_bytes=getattr(mem, "temp_size_in_bytes", None),
             count_buffer_bytes=q * c * 4, scale=key_scale(c))


def _timed(serve, batches) -> float:
    serve(batches[0])  # compile
    times = []
    for _ in range(REPEATS):
        for b in batches:
            t0 = time.perf_counter()
            serve(b)
            times.append(time.perf_counter() - t0)
    return 1000 * float(np.median(times))


def ab(lsh, cell: str, batches, mode=None) -> None:
    store = lsh._storage
    res = {"xla": [], "kernel": []}
    for variant in ("xla", "kernel", "kernel", "xla"):
        if variant == "xla":
            store._scan_kernel = lambda width=16: None
        else:
            store.__dict__.pop("_scan_kernel", None)
        res[variant].append(_timed(lsh.serving_fn(cs.TOP_K, mode=mode), batches))
    store.__dict__.pop("_scan_kernel", None)
    emit(cell=cell, mode=mode, batch=BATCH, ms_xla=res["xla"], ms_kernel=res["kernel"],
         impl=store.stats()["scan_kernel"])


def run_ab(seed: int) -> None:
    import jax

    from lshrs_tpu import LSHRS

    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    kw = dict(dim=cs.DIM, num_perm=256, num_bands=16, rows_per_band=16)

    x = cs.synth(key, 100_000, cs.DIM)
    lsh = LSHRS(engine="collision", initial_capacity=1 << 17, **kw)
    cs.build(lsh, x)
    batches = [cs.plant(x[rng.integers(0, x.shape[0], BATCH)], rng) for _ in range(2)]
    ab(lsh, "collision_100k", batches)
    del lsh, x

    x = cs.synth(jax.random.fold_in(key, 1), 1 << 20, cs.DIM)
    batches = [cs.plant(x[rng.integers(0, x.shape[0], BATCH)], rng) for _ in range(2)]
    lsh = LSHRS(engine="hamming", initial_capacity=1 << 20, **kw)
    cs.build(lsh, x)
    ab(lsh, "hamming_1m", batches)
    ab(lsh, "asymmetric_1m", batches, mode="asymmetric")
    del lsh, x

    lsh = LSHRS(engine="hamming", hamming_cascade=128, hamming_cascade_refine=8192,
                initial_capacity=1 << 22, **kw)
    n, step = 1 << 22, 1 << 19
    kept = None
    for off in range(0, n, step):
        xb = cs.synth(jax.random.fold_in(key, 100 + off), step, cs.DIM)
        if off == 0:
            kept = xb[:BATCH].copy()
        lsh.index(np.arange(off, off + step), xb)
    batches = [cs.plant(kept, rng) for _ in range(2)]
    ab(lsh, "cascade_4m", batches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from run_env import card_line, enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    print(f"card: {card_line()}", flush=True)
    if args.check:
        check_kernels()
    else:
        run_ab(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
