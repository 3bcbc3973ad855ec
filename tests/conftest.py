r"""Test configuration.

Tests run on the CPU with 8 virtual devices
(``--xla_force_host_platform_device_count=8``), so the multi-device sharded
paths run without a multi-GPU host.  ``BBLEAN_TPU_TEST_PLATFORM=cuda``
runs them on the GPU instead (``make test-gpu``); tests marked ``gpu`` need
the card and skip elsewhere (decided in the ``gpu_device`` fixture).

The native host library is built from source (``make native``) once per
session, under a file lock so parallel workers and concurrent sessions do
not race on the build.
"""

import fcntl
import os
import subprocess
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parent.parent
_platform = os.environ.get("BBLEAN_TPU_TEST_PLATFORM", "cpu")

if _platform == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, str(_ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)

from bblean_tpu._jax_cache import enable_persistent_cache  # noqa: E402

# The sharded SPMD programs take minutes to compile on a small CPU host;
# the persistent cache keeps them across sessions
enable_persistent_cache(min_compile_time_s=5.0)


def _build_native() -> None:
    build = _ROOT / "bblean_tpu" / "csrc" / "build"
    build.mkdir(parents=True, exist_ok=True)
    with open(build / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(
                ["make", "--no-print-directory", "native"], cwd=_ROOT,
                check=True, stdout=subprocess.DEVNULL,
            )
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def pytest_configure(config) -> None:
    _build_native()


@pytest.fixture(scope="session")
def gpu_device():
    r"""The first GPU device; skips the test where JAX sees none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform here: {dev.platform})")
    return dev
