"""Process set-up shared by ``chip_smoke.py`` and ``bench.py``.

These are the two programs that open the GPU; each opens it once, in its
own process. The library itself sets no compile cache and never checks
which device it runs on.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(root: str | os.PathLike | None = None) -> Path:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``.jax_cache/`` in the
    checkout (a fixed path: the cache key includes it)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return Path(root or Path(__file__).resolve().parent) / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def require_gpu() -> list:
    """JAX's devices, or exit with status 2 when the first is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"no GPU: JAX's first device is {devices[0].platform!r}; this "
            "program measures the GPU and does not fall back",
            file=sys.stderr,
        )
        sys.exit(2)
    return devices


def device_record(devices: list) -> dict:
    """The device as JAX reports it (the keys every result line carries)."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
