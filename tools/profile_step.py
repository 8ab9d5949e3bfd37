"""Break a dense WCSPH step into its phases and time each on hardware.

Each phase is timed as a jitted function whose outputs are reduced to ONE
scalar on device before fetching — fetching full planes (80 MB each at 1M
particles) times the host transfer, not the device.

Usage: python tools/profile_step.py [n3]
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.ops.cellops import DenseCellSpec, build_planes, dense_indices, gather_plane
from dieselfluid_tpu.ops.pallas_sph import density_planes, force_planes
from dieselfluid_tpu.ops.smoothing import KernelCoeffs, tait_eos
from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step

n3 = int(sys.argv[1]) if len(sys.argv) > 1 else 100
extent = 0.5
dx = (2.0 / n3) * extent
params = FluidParams.for_spacing(dx)
state = dam_break_state(n3, params, extent=extent)
params = params.replace(d0=float(1.1 * params.d0))
off = params.h / 4.0
spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                capacity=16)
k = KernelCoeffs.build(params.h)
print(f"n3={n3} N={n3**3} spec rows={spec.rows} sub={spec.sub} "
      f"plane={spec.plane_shape}")


def timeit(name, fn, *args, reps=10):
    """fn must return a SCALAR (device-reduced); fetches are then tiny."""
    jfn = jax.jit(fn)
    out = np.asarray(jfn(*args))           # compile + run once
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jfn(*args)
    out = np.asarray(out)                  # hard sync via scalar fetch
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"  {name:32s} {ms:8.2f} ms   (check={out:.4g})")


pos, vel = state.pos, state.vel
flat, valid, ovf = jax.jit(lambda p: dense_indices(p, spec))(pos)
print(f"  overflow={int(ovf)}")


def mk_planes(p, v, fl, va):
    return build_planes(
        {"x": p[:, 0], "y": p[:, 1], "z": p[:, 2],
         "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2]}, fl, va, spec)


planes = jax.jit(mk_planes)(pos, vel, flat, valid)
rho_plane = jax.jit(lambda pl_: density_planes(pl_, spec, k, params.mass))(planes)
press_plane = jax.jit(lambda rp, m: jnp.where(
    m > 0, tait_eos(rp, params.d0, params.p0, params.tait_gamma, params.tait_w),
    0.0))(rho_plane, planes["mask"])

timeit("dense_indices (argsort)",
       lambda p: dense_indices(p, spec)[0].sum(), pos)
timeit("build_planes (scatter x7)",
       lambda p, v, fl, va: sum(x.sum() for x in
                                mk_planes(p, v, fl, va).values()),
       pos, vel, flat, valid)
timeit("density_planes (pallas)",
       lambda pl_: density_planes(pl_, spec, k, params.mass).sum(), planes)
timeit("force_planes (pallas)",
       lambda pl_, rp, pp: sum(x.sum() for x in force_planes(
           pl_, rp, pp, spec, k, params.mass, float(params.mu))),
       planes, rho_plane, press_plane)
timeit("gather_plane x1",
       lambda rp, fl: gather_plane(rp, fl).sum(), rho_plane, flat)
timeit("full dense_wcsph_step",
       lambda s: dense_wcsph_step(s, params, spec)[0].pos.sum(), state,
       reps=5)
