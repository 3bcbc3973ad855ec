r"""CPU rehearsal of ``chip_smoke.py`` at tiny sizes, its device check, the
compile-cache placement, and the dependency-free device half of ``bb run``.

The phases run here on the CPU backend (4 of the 8 virtual devices for the
four-card path); on a GPU the ``gpu`` test runs phase 1 at real widths.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def rep():
    return cs.Report("CPU rehearsal")


def test_phase_kernels_tiny(rep, capsys) -> None:
    cs.phase_kernels(
        rep, m=256, g_live=40, g_cap=64, block=32, n_groups=24, fc=16,
        tan_centroids=48, n_cand=256,
    )
    out = capsys.readouterr().out
    for name in ("route", "tanimoto_matmul", "tile_search", "merge radius"):
        assert f"phase1 {name}" in out


def test_phase_engine_tiny(rep, capsys) -> None:
    cs.phase_engine(rep, rows=1200, batch=128, thresholds=(0.65,))
    out = capsys.readouterr().out
    assert "deterministic=True" in out and "cpu_labels_identical=True" in out


def test_phase_scale_tiny(rep, tmp_path, capsys) -> None:
    cs.phase_scale(rep, rows=2048, batch=64, workdir=tmp_path)
    out = capsys.readouterr().out
    assert "memory_analysis" in out
    assert "bb run --engine batch (warm)" in out
    assert (tmp_path / "run-warm" / "clusters.pkl").exists()


def test_phase_four_cards_tiny(rep, capsys) -> None:
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (the CPU tests have 8 virtual ones)")
    cs.phase_four_cards(rep, rows_per_card=1024, batch=64)
    assert "clusters_ratio" in capsys.readouterr().out


def test_device_fingerprints_popcount_law() -> None:
    import numpy as np

    fps = np.asarray(cs.device_fingerprints(3000, seed=1, chunk=1024))
    assert fps.shape == (3000, cs.F // 8) and fps.dtype == np.uint8
    pops = np.unpackbits(fps, axis=-1).sum(1)
    assert 1 <= pops.min() and pops.max() <= cs.F - 1
    assert 700 < pops.mean() < 900  # truncated normal(750, 400) on [1, 2047]
    assert len(np.unique(fps, axis=0)) == 3000


def test_require_gpu_refuses_cpu() -> None:
    with pytest.raises(SystemExit) as exc:
        cs.require_gpu(jax.devices("cpu"))
    assert exc.value.code != 0


def test_script_fails_without_gpu() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_gpu_kernels_at_real_widths(gpu_device, rep) -> None:
    cs.phase_kernels(rep)


_CACHE_PROBE = (
    "import jax; from bblean_tpu._jax_cache import enable_persistent_cache;"
    "enable_persistent_cache(); print(jax.config.jax_compilation_cache_dir)"
)


def _probe_cache_dir(env_dir):
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_COMPILATION_CACHE_DIR", "BBLEAN_TPU_NO_JAX_CACHE")
    }
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    proc = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return proc.stdout.strip().splitlines()[-1]


def test_cache_defaults_to_checkout() -> None:
    assert _probe_cache_dir(None) == str(ROOT / ".jax_cache")


def test_cache_respects_env(tmp_path) -> None:
    assert _probe_cache_dir(str(tmp_path)) == str(tmp_path)


def test_device_run_imports_no_cli_dependencies() -> None:
    code = (
        "import sys, json, bblean_tpu.engine.run;"
        "print(json.dumps(sorted({'click', 'rich', 'psutil'}"
        " & set(sys.modules))))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
