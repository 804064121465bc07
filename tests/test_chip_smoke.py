"""``chip_smoke.py`` on the CPU: its NumPy reference oracles, its phases at
tiny sizes (kernels in Pallas' interpreter), and its refusal to run
without a GPU."""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops.hamming import unpack_bitplanes

ROOT = Path(__file__).resolve().parents[1]


def _words(rng, n, bw, hi=4):
    return rng.integers(0, hi, (n, bw)).astype(np.uint32)


def test_ref_collision_topk_matches_brute_force(rng):
    nb, wpb, k = 4, 2, 5
    sig = _words(rng, 300, nb * wpb)
    ids = rng.permutation(5000)[:300].astype(np.int64)
    q = _words(rng, 6, nb * wpb)
    got = cs.ref_collision_topk(sig, ids, q, num_bands=nb, k=k)
    for i in range(6):
        counts = [
            sum((sig[s, b * wpb:(b + 1) * wpb] == q[i, b * wpb:(b + 1) * wpb]).all()
                for b in range(nb))
            for s in range(300)
        ]
        want = sorted((-c, int(ids[s])) for s, c in enumerate(counts) if c > 0)[:k]
        want = [i_ for _, i_ in want] + [-1] * (k - len(want))
        assert got[i].tolist() == want


@pytest.mark.parametrize("bw", [8, 3])  # even and odd word counts (u64 view pads)
def test_ref_hamming_topk_matches_brute_force(rng, bw):
    sig = _words(rng, 200, bw, hi=2**32)
    ids = rng.permutation(1000)[:200].astype(np.int64)
    sig[50] = sig[10]  # an exact tie: lower id first
    q = np.concatenate([sig[10:11], _words(rng, 3, bw, hi=2**32)])
    got = cs.ref_hamming_topk(sig, ids, q, k=7)
    for i in range(q.shape[0]):
        ham = [sum(bin(int(a ^ b)).count("1") for a, b in zip(sig[s], q[i]))
               for s in range(200)]
        want = [int(ids[s]) for s in sorted(range(200), key=lambda s: (ham[s], ids[s]))[:7]]
        assert got[i].tolist() == want


@pytest.mark.parametrize("num_bands,rows", [(4, 8), (2, 40)])
def test_unpack_planes_matches_store_bitplanes(rng, num_bands, rows):
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=16, seed=3)
    words = h.hash_batch_words_host(rng.standard_normal((50, 16)).astype(np.float32))
    want = np.asarray(unpack_bitplanes(words, num_bands=num_bands, rows_per_band=rows))
    got = cs.unpack_planes(words, num_bands=num_bands, rows_per_band=rows)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_ref_asymmetric_dots_are_exact_integers(rng):
    planes = rng.choice([-1.0, 1.0], (100, 256)).astype(np.float32)
    qi8 = rng.integers(-127, 128, (3, 256)).astype(np.int8)
    want = qi8.astype(np.int64) @ planes.astype(np.int64).T
    np.testing.assert_array_equal(cs.ref_asymmetric_dots(planes, qi8), want)


def test_ref_topp_orders_colliding_candidates(rng):
    nb = 4
    x = rng.standard_normal((80, 8)).astype(np.float32)
    ids = np.arange(100, 180, dtype=np.int64)
    sig = _words(rng, 80, nb, hi=3)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    qw = _words(rng, 3, nb, hi=3)
    out = cs.ref_topp(x, ids, sig, q, qw, num_bands=nb, p=0.3, max_out=4)
    for i, (got_ids, got_cos) in enumerate(out):
        cand = [s for s in range(80) if (sig[s] == qw[i]).any()]
        cos = {s: float(x[s] @ q[i] / np.linalg.norm(x[s]) / np.linalg.norm(q[i]))
               for s in cand}
        order = sorted(cand, key=lambda s: (-cos[s], ids[s]))
        limit = min(max(1, math.ceil(len(cand) * 0.3)), 4) if cand else 0
        assert got_ids.tolist() == [int(ids[s]) for s in order[:limit]]
        np.testing.assert_allclose(got_cos, [cos[s] for s in order[:limit]], atol=1e-6)


def test_bit_share_counts_differing_bits():
    a = np.zeros((2, 4), np.uint32)
    b = a.copy()
    b[0, 0], b[1, 3] = 0b1011, 1 << 31
    assert cs.bit_share(a, b) == 4 / (8 * 32)
    assert cs.bit_share(a, a) == 0.0


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Serve through the GPU kernels in Pallas' interpreter, as the card
    serves through them compiled."""
    import lshrs_tpu.storage.device as dev

    real = dev.scan_kernel

    def route(c, g, width=16):
        return "interpret" if real(c, g, width=width, platform="gpu") else None

    monkeypatch.setattr(dev, "scan_kernel", route)


@pytest.mark.parametrize("phase", ["collision", "hamming", "cascade", "four_cards"])
def test_phases_pass_at_tiny_size(interpret_kernels, phase):
    key, rng = jax.random.PRNGKey(0), np.random.default_rng(0)
    kw = dict(dim=32, q=64)
    if phase == "collision":
        out = cs.phase_collision(key, rng, n=3000, n_check=32, **kw)
        cs.phase_hash(key, n=256, dim=32, built=out.pop("_store"))
        assert out["kernel_vs_xla"] == "interpret" and out["mismatches"] == 0
    elif phase == "hamming":
        out = cs.phase_hamming(key, rng, n=4096, n_check=32, engine="hamming", **kw)
        assert out["kernel_vs_xla"] == ["interpret", "interpret"]
    elif phase == "cascade":
        out = cs.phase_cascade(key, rng, n=1 << 13, n_check=32, **kw)
        assert out["planted_recall10"] >= cs.PLANTED_RECALL_MIN
    else:
        out = cs.phase_four_cards(key, rng, n=1 << 13, shards=4, n_check=32, **kw)
        assert out["devices"] == [0, 1, 2, 3] and out["tied_pairs_checked"] > 0


def test_smoke_fails_on_a_wrong_answer(rng, monkeypatch):
    """A reference that disagrees with the engine fails the phase."""
    monkeypatch.setattr(cs, "ref_collision_topk", lambda *a, **k: np.full((32, 10), 7))
    with pytest.raises(cs.SmokeFailure, match="differ"):
        cs.phase_collision(jax.random.PRNGKey(0), rng, n=2000, dim=32, q=64, n_check=32)


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_smoke_exits_nonzero_without_gpu():
    res = _run(["chip_smoke.py"], ROOT)
    assert res.returncode == 2
    assert res.stdout.strip() == ""
    assert "no GPU" in res.stderr


def test_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_bench_exits_nonzero_without_gpu():
    res = _run(["bench.py"], ROOT)
    assert res.returncode == 2
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("env", [None, "/some/cache"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env):
    """``$JAX_COMPILATION_CACHE_DIR`` wins; otherwise ``.jax_cache/`` in
    the checkout, a fixed path."""
    import run_env

    if env is None:
        monkeypatch.delenv(run_env.CACHE_ENV, raising=False)
        assert run_env.compile_cache_dir() == ROOT / ".jax_cache"
        assert run_env.compile_cache_dir(tmp_path) == tmp_path / ".jax_cache"
    else:
        monkeypatch.setenv(run_env.CACHE_ENV, env)
        assert run_env.compile_cache_dir(tmp_path) == Path(env)


def test_library_sets_no_compile_cache():
    import lshrs_tpu  # noqa: F401

    assert jax.config.jax_compilation_cache_dir == os.environ.get(
        "JAX_COMPILATION_CACHE_DIR"
    )
