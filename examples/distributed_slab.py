"""Multi-device dense PCISPH over a slab-decomposed mesh.

    python examples/distributed_slab.py          # every GPU JAX finds
    python examples/distributed_slab.py --cpu    # 8 virtual CPU devices

Slab domain decomposition with plane-column halo exchange on the dense
pipeline, per-slab load diagnostics, and a sharded checkpoint (needs orbax)
— the production multi-device recipe in ~60 lines.
"""

import argparse
import os

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true",
                help="run on 8 virtual CPU devices instead of the GPUs")
ap.add_argument("--n3", type=int, default=8,
                help="cubic root of the particle count")
args = ap.parse_args()
if args.cpu:
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from dieselfluid_tpu.config import FluidParams  # noqa: E402
from dieselfluid_tpu.models.particles import dam_break_state  # noqa: E402
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density  # noqa: E402
from dieselfluid_tpu.parallel.dense_halo import (  # noqa: E402
    DenseSlabSpec,
    distribute_dense,
    make_dense_halo_pcisph_step,
)
from dieselfluid_tpu.parallel.sharding import particle_mesh  # noqa: E402
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta  # noqa: E402

n_dev = len(jax.devices())
print(f"{n_dev} x {jax.devices()[0].device_kind}")
n3, extent = args.n3, 0.5
dx = (2.0 / n3) * extent
params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
state = dam_break_state(n3, params, extent=extent)
delta = compute_pci_delta(params, dx)

mesh = particle_mesh(n_dev)
spec = DenseSlabSpec.build_for_state(state, n_dev, params.h,
                                     migrate_capacity=128, cell_capacity=32)
slabs = distribute_dense(state, spec)
step = make_dense_halo_pcisph_step(mesh, spec, params, delta, warm_start=True)

for frame in range(4):
    slabs, max_vel, n_live, ovf, per_slab = step(slabs)
    jax.block_until_ready(slabs.pos)   # required on CPU-emulated meshes
    if frame % 2 == 0:
        occ = np.asarray(per_slab).astype(int)
        print(f"frame {frame}: n_live={int(n_live)} max|v|={float(max_vel):.3f} "
              f"overflow={int(ovf)} per-slab={occ.tolist()} "
              f"imbalance={occ.max() / max(occ.mean(), 1):.2f}")

from dieselfluid_tpu.io.checkpoint import (  # noqa: E402
    load_slab_checkpoint, save_slab_checkpoint)

save_slab_checkpoint("out/slab_ckpt", slabs, 4, params)
restored, frame, _ = load_slab_checkpoint("out/slab_ckpt")
assert frame == 4 and float(np.abs(
    np.asarray(restored.pos) - np.asarray(slabs.pos)).max()) < 1e-6
print("checkpoint round-trip OK — resume with the same step function")
