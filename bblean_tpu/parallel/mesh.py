r"""Device-mesh helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["get_mesh"]


def get_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    r"""A 1-D mesh over the first ``n_devices`` devices (all by default).

    Clustering is data-parallel over fingerprint rows, so one ``dp`` axis
    is all the mesh needs: the GPUs of one host reach each other all to all
    over NVLink at the same rate, and XLA hands the collectives to NCCL.
    """
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices, only {len(devices)} visible"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=(axis_name,))
