"""Stencil-sweep implementations compared on the card, at the 1M dam break.

Builds the dam break through the served path (`Simulation.create`, dense
neighbours) and, for each sweep implementation (the Triton kernel and the
plain-XLA `_sweep_xla`, in turns: triton, xla, xla, triton), times the
jitted dense WCSPH and PCISPH steps after a warm-up. Also checks every
production sweep's Triton output against `_sweep_xla` at full width, prints
the compiled step's memory analysis, and times each sweep alone under a
few Triton (own block, `num_warps`, wide) launches.

    python tools/sweep_ab.py [--n3 100] [--capacity 32] [--steps 10]

Needs a GPU; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dieselfluid_tpu.config import SimConfig  # noqa: E402
from dieselfluid_tpu.models.sph import Simulation  # noqa: E402
from dieselfluid_tpu.ops import pallas_sph as ps  # noqa: E402
from dieselfluid_tpu.ops.cellops import (  # noqa: E402
    DenseCellSpec, build_planes, dense_indices)
from dieselfluid_tpu.ops.smoothing import KernelCoeffs  # noqa: E402
from dieselfluid_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

_PRODUCTION_SWEEP = ps._sweep
# (own block, num_warps, wide) launches of the Triton sweep timed per sweep.
_VARIANTS = ((64, 8, True), (64, 16, True), (32, 16, False), (32, 4, False))


def _use(impl: str):
    """Route every sweep through one implementation (takes effect at the
    next trace, so jit caches are cleared)."""
    if impl == "triton":
        ps._sweep = _PRODUCTION_SWEEP
    else:
        ps._sweep = lambda pair, names, n_out, planes, spec, kind="force": (
            ps._sweep_xla(pair, names, n_out, planes, spec))
    jax.clear_caches()


def _timed(fn, *args, reps: int = 5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def time_steps(solver: str, n3: int, capacity: int, steps: int):
    sim = Simulation.create(SimConfig(n3=n3, solver=solver, neighbors="dense",
                                      cell_capacity=capacity))
    s0 = sim.state
    t0 = time.perf_counter()
    st, d = sim.step_fn(s0)
    jax.block_until_ready(st.pos)
    compile_s = time.perf_counter() - t0
    st, d = sim.step_fn(st)
    jax.block_until_ready(st.pos)
    t0 = time.perf_counter()
    for _ in range(steps):
        st, d = sim.step_fn(st)
    jax.block_until_ready(st.pos)
    ms = (time.perf_counter() - t0) / steps * 1e3
    return ms, compile_s, int(d.overflow), sim


def sweep_cases(spec, k, mass, mu):
    return [
        ("density", ps._density_pair(k), ps._D_IN, 1),
        ("fused_force", ps._force_fold_pair(k, mass, mu), ps._F_IN_FOLD, 3),
        ("pq_pressure", ps._press_pq_pair(k), ps._PQ_IN, 3),
        ("force_vjp", ps._bwd_pair(ps._force_pair(k, mass, mu), 3,
                                   ps._F_GRAD),
         ps._F_IN + ("ct_0", "ct_1", "ct_2"), len(ps._F_GRAD)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n3", type=int, default=100)
    ap.add_argument("--capacity", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    enable_compile_cache()
    print("device:", jax.devices()[0].device_kind, flush=True)

    # Parity + per-sweep timing on planes of the initial dam break.
    sim = Simulation.create(SimConfig(n3=args.n3, neighbors="dense",
                                      cell_capacity=args.capacity))
    p = sim.params
    spec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), p.h,
                                    capacity=args.capacity)
    pos, vel = sim.state.pos, sim.state.vel
    flat, valid, ovf = dense_indices(pos, spec)
    key = jax.random.PRNGKey(0)
    extra = {n: jax.random.uniform(jax.random.fold_in(key, i),
                                   (pos.shape[0],), minval=0.5, maxval=2.0)
             for i, n in enumerate(("rho", "press", "pq", "iv",
                                    "ct_0", "ct_1", "ct_2"))}
    planes = build_planes({"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
                           "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2],
                           **extra}, flat, valid, spec)
    k = KernelCoeffs.build(p.h)
    print(f"spec {spec.plane_shape} overflow {int(ovf)}", flush=True)
    for name, pair, names, n_out in sweep_cases(spec, k, p.mass, p.mu):
        ins = [planes[n] for n in names]
        xla = jax.jit(lambda *a, pair=pair, names=names, n_out=n_out:
                      ps._sweep_xla(pair, names, n_out, a, spec))
        ref = xla(*ins)
        scale = max(float(jnp.max(jnp.abs(b))) for b in ref)
        row = [name]
        for block, nw, wide in _VARIANTS:
            tri = jax.jit(lambda *a, pair=pair, names=names, n_out=n_out,
                          block=block, nw=nw, wide=wide: ps._sweep_triton(
                              pair, names, n_out, a, spec, block=block,
                              num_warps=nw, wide=wide))
            out = tri(*ins)
            err = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(out, ref))
            row.append(f"b{block}w{nw}{'wide' if wide else ''} "
                       f"{_timed(tri, *ins):.3f} ms relerr {err / scale:.2e}")
        row.append(f"xla {_timed(xla, *ins, reps=2):.3f} ms")
        print("sweep", " | ".join(row), flush=True)

    analysed = set()
    for impl in ("triton", "xla", "xla", "triton"):
        _use(impl)
        for solver in ("wcsph", "pcisph"):
            ms, cs, ovf, sim = time_steps(solver, args.n3, args.capacity,
                                          args.steps)
            print(f"step {impl} {solver} n={sim.n()} {ms:.3f} ms/step "
                  f"(first call {cs:.1f} s, overflow {ovf})", flush=True)
        if impl not in analysed:
            analysed.add(impl)
            lowered = jax.jit(sim.step_fn).lower(sim.state)
            print(f"memory_analysis {impl} pcisph:",
                  lowered.compile().memory_analysis(), flush=True)
    _use("triton")
    return 0


if __name__ == "__main__":
    sys.exit(main())
