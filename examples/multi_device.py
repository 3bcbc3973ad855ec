"""SPMD sharded clustering over a device mesh.

Runs on whatever devices JAX sees. To try the full multi-chip path on a
CPU-only machine, launch with a virtual 8-device mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multi_device.py

On a host with several GPUs the same script uses every card (collectives
over NVLink).
"""

import numpy as np

import jax

from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu.parallel import get_mesh, sharded_fit
from bblean_tpu.similarity import jt_isim_from_sum

fps = make_fake_fingerprints(20_000, n_features=2048, seed=3, pack=True)

mesh = get_mesh()  # 1-D mesh over every visible device
print(f"devices: {mesh.devices.size} x {jax.devices()[0].device_kind}")

result = sharded_fit(
    fps,
    mesh,
    input_is_packed=True,
    threshold=0.30,
    merge_criterion="diameter",
    # Merge rounds may use a laxer criterion, like multiround's midsection:
    merge_criterion_merge="tolerance-diameter",
    batch_size=512,
)

print(f"{result.num_clusters} clusters over {len(result.labels)} rows")
sizes = np.sort(result.sizes)[::-1]
print(f"largest: {sizes[:5].tolist()}")

# Cohesion invariant: every multi-member cluster satisfies the criterion
worst = 1.0
for ls, n in zip(result.linear_sums, result.sizes):
    if n >= 2:
        worst = min(worst, jt_isim_from_sum(ls.astype(np.uint64), int(n)))
print(f"worst multi-member cluster iSIM: {worst:.3f} (threshold 0.30)")
