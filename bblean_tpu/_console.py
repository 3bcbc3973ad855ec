r"""Rich console with banner/config printing + silent null-object variant.

Parity notes: mirrors reference ``bblean/_console.py`` (``BBConsole``
``:14-156``, ``SilentConsole`` ``:159-177``, ``get_console`` ``:184``).
"""

from __future__ import annotations

import os
import typing as tp
from pathlib import Path

from rich.console import Console

__all__ = ["get_console"]

_BANNER = r"""
 _     _     _                        _
| |__ | |__ | | ___  __ _ _ __      | |_ _ __  _   _
| '_ \| '_ \| |/ _ \/ _` | '_ \ _____| __| '_ \| | | |
| |_) | |_) | |  __/ (_| | | | |_____| |_| |_) | |_| |
|_.__/|_.__/|_|\___|\__,_|_| |_|      \__| .__/ \__,_|
                                         |_|
      BitBIRCH molecular clustering on JAX devices
"""


class BBConsole(Console):
    r"""Console with bblean-tpu banner and config pretty-printing."""

    def print_banner(self) -> None:
        if os.getenv("BITBIRCHNOBANNER") or os.getenv("BBLEAN_TPU_NOBANNER"):
            return
        self.print(f"[bold cyan]{_BANNER}[/bold cyan]", highlight=False)

    def print_config(self, config: tp.Mapping[str, tp.Any], title: str = "Config") -> None:
        self.print(f"[bold]{title}:[/bold]")
        for key, value in config.items():
            self.print(f"    - {key}: [yellow]{value}[/yellow]")
        self.print()

    def print_multiround_config(self, config: tp.Mapping[str, tp.Any]) -> None:
        self.print_config(config, title="Multi-round config")

    def print_peak_mem(self, out_dir: Path | str) -> None:
        path = Path(out_dir) / "max-rss.txt"
        if path.exists():
            self.print(f"    - Peak RSS so far: {path.read_text().strip()}")

    def print_peak_hbm(self) -> None:
        r"""Device-memory summary line (no-op when the backend has none)."""
        import sys

        if "jax" not in sys.modules:
            return
        from bblean_tpu._memory import device_memory_stats

        stats = device_memory_stats()
        if not stats:
            return
        peak = stats.get("peak_bytes_in_use")
        limit = stats.get("bytes_limit")
        if peak is None:
            return
        line = f"    - Peak device memory: {peak / 2**30:.2f} GiB"
        if limit:
            line += f" of {limit / 2**30:.1f} GiB"
        self.print(line)


class SilentConsole:
    r"""Null-object console used under ``--no-verbose``."""

    def print(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_banner(self) -> None:
        pass

    def print_config(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_multiround_config(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_peak_mem(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_peak_hbm(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def status(self, *args: tp.Any, **kwargs: tp.Any) -> tp.ContextManager:
        import contextlib

        return contextlib.nullcontext()


def get_console(verbose: bool = True, silent: bool | None = None) -> tp.Any:
    r"""Console factory: a rich BBConsole, or a silent null object."""
    if silent is None:
        silent = not verbose
    if silent:
        return SilentConsole()
    return BBConsole()
