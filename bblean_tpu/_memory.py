r"""Host memory management: streaming mmap loads and RSS monitoring.

Parity notes (reference ``bblean/_memory.py``):

- ``_mmap_file_and_madvise_sequential`` maps a ``.npy`` read-only and advises
  the kernel of sequential access (reference ``_memory.py:110-126``).
- ``_ArrayMemPagesManager`` releases consumed 2 MiB super-pages with
  ``madvise(DONTNEED)`` while the fit loop streams over a mapped array,
  keeping resident memory flat (reference ``_memory.py:73-107``).
- ``launch_monitor_rss_daemon`` samples process-tree RSS into
  ``monitor-rss.csv`` / ``max-rss.txt`` (reference ``_memory.py:143-198``).

On device runs the analogous scale axis is device memory:
``device_memory_stats`` snapshots the backend's allocator stats
(peak/current bytes in use, limit) for ``config.json`` and the console
summary.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import enum
import mmap
import multiprocessing as mp
import os
import sys
import time
import typing as tp
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

__all__ = ["system_mem_gib", "launch_monitor_rss_daemon", "device_memory_stats"]

# Release granularity: 512 hardware pages (2 MiB with 4 KiB pages)
_SUPER_PAGE_BYTES = mmap.PAGESIZE * 512


class Madv(enum.IntEnum):
    NORMAL = 0
    RANDOM = 1
    SEQUENTIAL = 2
    WILLNEED = 3
    DONTNEED = 4


def _libc() -> ctypes.CDLL | None:
    if sys.platform != "linux":
        return None
    try:
        return ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
    except OSError:  # pragma: no cover
        return None


def _madvise(addr: int, length: int, advice: Madv) -> None:
    lib = _libc()
    if lib is None:
        return
    # Align the start address down to a page boundary
    aligned = addr - (addr % mmap.PAGESIZE)
    length += addr - aligned
    lib.madvise(ctypes.c_void_p(aligned), ctypes.c_size_t(length), int(advice))


def system_mem_gib() -> tuple[float, float]:
    r"""(total, available) system memory in GiB."""
    try:
        import psutil

        vm = psutil.virtual_memory()
        return vm.total / 2**30, vm.available / 2**30
    except ImportError:  # pragma: no cover
        return 0.0, 0.0


def device_memory_stats(device: tp.Any = None) -> dict[str, int] | None:
    r"""Accelerator memory stats of ``device`` (default: first device).

    The device analogue of the host-RSS telemetry the reference records per run
    (``bblean/_memory.py:143-198``): a device framework's scarce resource is
    device memory, so runs persist ``peak_bytes_in_use``/``bytes_limit`` next to the
    host numbers.  Returns None when the backend exposes no stats (CPU).
    """
    try:
        import jax

        dev = device if device is not None else jax.local_devices()[0]
        stats = dev.memory_stats()
    except Exception:
        return None
    if not stats:
        return None
    return {k: int(v) for k, v in stats.items() if isinstance(v, (int, float))}


def _mmap_file_and_madvise_sequential(
    path: Path, max_fps: int | None = None
) -> NDArray[np.integer]:
    r"""Memory-map a ``.npy`` file read-only with sequential access advice."""
    arr = np.load(path, mmap_mode="r")
    if max_fps is not None:
        arr = arr[:max_fps]
    if isinstance(arr, np.memmap):
        _madvise(arr.ctypes.data, arr.nbytes, Madv.SEQUENTIAL)
    return arr


class _ArrayMemPagesManager:
    r"""Release already-consumed super-pages of a mapped array during a scan."""

    def __init__(self, arr: NDArray[np.integer], can_release: bool) -> None:
        self._arr = arr
        self.can_release = can_release and isinstance(arr, np.memmap)
        if len(arr) and arr.ndim == 2:
            self._rows_per_page = max(_SUPER_PAGE_BYTES // max(arr.strides[0], 1), 1)
        else:
            self._rows_per_page = 1 << 62
        self._page_start_row = 0

    @classmethod
    def from_bb_input(
        cls, X: tp.Any, can_release: bool = True
    ) -> "_ArrayMemPagesManager":
        if isinstance(X, np.ndarray):
            return cls(X, can_release)
        return cls(np.empty((0, 0), dtype=np.uint8), False)

    def should_release_curr_page(self, rows_consumed: int) -> bool:
        return rows_consumed - self._page_start_row >= self._rows_per_page

    def release_curr_page_and_update_addr(self) -> None:
        start = self._page_start_row
        end = start + self._rows_per_page
        base = self._arr.ctypes.data + start * self._arr.strides[0]
        _madvise(base, (end - start) * self._arr.strides[0], Madv.DONTNEED)
        self._page_start_row = end


def _monitor_rss(out_dir: Path, parent_pid: int, interval_s: float) -> None:
    import psutil

    csv_path = Path(out_dir) / "monitor-rss.csv"
    max_path = Path(out_dir) / "max-rss.txt"
    max_rss = 0
    t0 = time.monotonic()
    with open(csv_path, "wt", encoding="utf-8") as f:
        f.write("time_s,rss_gib\n")
        while True:
            try:
                parent = psutil.Process(parent_pid)
                procs = [parent] + parent.children(recursive=True)
                rss = 0
                for p in procs:
                    try:
                        rss += p.memory_info().rss
                    except psutil.NoSuchProcess:
                        pass
            except psutil.NoSuchProcess:
                break
            max_rss = max(max_rss, rss)
            f.write(f"{time.monotonic() - t0:.2f},{rss / 2**30:.4f}\n")
            f.flush()
            with open(max_path, "wt", encoding="utf-8") as mf:
                mf.write(f"{max_rss / 2**30:.4f} GiB\n")
            time.sleep(interval_s)


def launch_monitor_rss_daemon(
    out_dir: Path | str, interval_s: float = 1.0
) -> mp.Process:
    r"""Start a daemon process sampling process-tree RSS into the run dir."""
    proc = mp.get_context("spawn").Process(
        target=_monitor_rss,
        args=(Path(out_dir), os.getpid(), interval_s),
        daemon=True,
    )
    proc.start()
    return proc
