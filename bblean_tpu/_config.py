r"""CLI defaults and run-metadata (``config.json``) collection.

Default values are parity-pinned to the reference CLI defaults
(``bblean/_config.py:22-36``); the spec dump is annotated with
accelerator device/backend info on top of the reference's host fields.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import sys
import typing as tp
from pathlib import Path


@dataclasses.dataclass(slots=True)
class BitBirchConfig:
    threshold: float = 0.30
    branching_factor: int = 254
    merge_criterion: str = "diameter"
    refine_merge_criterion: str = "tolerance-diameter"
    refine_threshold_change: float = 0.0
    tolerance: float = 0.05
    n_features: int = 2048
    fp_kind: str = "ecfp4"


DEFAULTS = BitBirchConfig()

TSNE_SEED = 42


def _host_specs() -> dict[str, tp.Any]:
    r"""Hardware / software environment facts worth recording per run."""
    import numpy as np

    from bblean_tpu._memory import system_mem_gib
    from bblean_tpu.utils import (
        _accelerators,
        _cpu_name,
        native_extensions_are_enabled,
        native_extensions_are_installed,
    )

    total_mem, avail_mem = system_mem_gib()
    return {
        "native_extensions_enabled": native_extensions_are_enabled(),
        "native_extensions_installed": native_extensions_are_installed(),
        "total_memory_gib": total_mem,
        "initial_available_memory_gib": avail_mem,
        "platform": sys.platform,
        "cpu": _cpu_name(),
        **_accelerators(),
        "numpy_version": np.__version__,
        "python_version": sys.version.split()[0],
    }


def collect_system_specs_and_dump_config(config: dict[str, tp.Any]) -> None:
    r"""Write ``<out_dir>/config.json``: run params + system specs."""
    record = dict(config)
    record.update(_host_specs())
    if "jax" in sys.modules:  # device engines only — never init jax here
        from bblean_tpu._memory import device_memory_stats

        hbm = device_memory_stats()
        if hbm is not None:
            record["device_memory"] = hbm
    if record.get("num_processes", 1) > 1:
        record["multiprocessing_start_method"] = mp.get_start_method()
        record["visible_cpu_cores"] = os.cpu_count()
    out = Path(record["out_dir"]) / "config.json"
    out.write_text(json.dumps(record, indent=4), encoding="utf-8")
