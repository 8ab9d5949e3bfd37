"""Smoke test of the dense SPH pipeline on NVIDIA GPUs.

    python chip_smoke.py            # phases a-f on one GPU
    python chip_smoke.py --four     # only the 4-GPU slab-decomposed phase

Phases, one line each (a failing phase raises, and the script exits
nonzero without printing a result):

  a. device: JAX's devices, and nvidia-smi's name and power limit;
  b. sweep parity at the 1M dam break: each production stencil sweep
     (density, fused force, PCISPH pq pressure, the force VJP) against the
     plain-XLA `_sweep_xla`; the compiled 1M step holds the Triton kernel;
     dense density and forces against the XLA cell-grid path at 262k;
  c. the served path, `app.cli.main` in process: dense WCSPH 20 steps and
     dense PCISPH 10 steps at --n3 100, and one 1080p render frame;
  d. one 1M plane-resident WCSPH window (solvers.dense_resident);
  e. jax.grad through the unrolled dense PCISPH step w.r.t. Materials;
  f. splat render forward + backward, 512k particles at 1920x1080.

  --four: the 1-D slab-decomposed WCSPH and PCISPH steps
  (parallel/dense_halo.py) on a 4-GPU mesh at 1M, against the single-GPU
  dense step from the same initial state.

The last line of stdout is {"ok": true, "device": {...}}. Without a GPU the
script exits 1 before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
# fp32 sums of up to 27 cells x capacity pair terms, taken in a different
# order by each implementation: bounded by n * eps relative to the largest
# term, about 5e-5 at capacity 32.
_SWEEP_TOL = 1e-4
# 262,144 particles: the cell-grid reference comparison and the gradient;
# 512,000: the splat render.
_N3_SMALL, _N3_SPLAT = 64, 80


_T0 = time.perf_counter()


def say(phase: str, msg: str) -> None:
    print(f"[{phase} +{time.perf_counter() - _T0:.0f}s] {msg}", flush=True)


def _timed(fn, *args, reps: int = 3):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / reps * 1e3


def _dam_break(n3: int, solver: str = "wcsph"):
    from dieselfluid_tpu.config import SimConfig
    from dieselfluid_tpu.models.sph import Simulation

    return Simulation.create(SimConfig(n3=n3, solver=solver,
                                       neighbors="dense"))


def _sound_speed(params) -> float:
    # FluidParams.for_spacing sets tait_w = d0 * c^2.
    return float(np.sqrt(params.tait_w / params.d0))


def phase_a() -> None:
    devs = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    say("a", f"devices {devs}")
    for line in smi.stdout.strip().splitlines():
        say("a", f"nvidia-smi {line.strip()}")


def phase_b_sweeps(n3: int):
    from dieselfluid_tpu.ops import pallas_sph as ps
    from dieselfluid_tpu.ops.cellops import (DenseCellSpec, build_planes,
                                             dense_indices)
    from dieselfluid_tpu.ops.smoothing import KernelCoeffs

    sim = _dam_break(n3)
    p, cfg = sim.params, sim.config
    spec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), p.h,
                                    capacity=cfg.cell_capacity)
    pos = sim.state.pos
    n = pos.shape[0]
    key = jax.random.PRNGKey(0)
    vel = jax.random.normal(key, pos.shape) * 0.1
    flat, valid, ovf = dense_indices(pos, spec)
    assert int(ovf) == 0, int(ovf)
    vals = {c: jax.random.uniform(jax.random.fold_in(key, i + 1), (n,),
                                  minval=0.5, maxval=2.0)
            for i, c in enumerate(("rho", "press", "pq", "iv",
                                   "ct_0", "ct_1", "ct_2"))}
    vals.update(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
                vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2])
    planes = build_planes(vals, flat, valid, spec)
    k = KernelCoeffs.build(p.h)
    cases = [   # (name, pair, channels, outputs, launch kind)
        ("density", ps._density_pair(k), ps._D_IN, 1, "density"),
        ("fused_force", ps._force_fold_pair(k, p.mass, p.mu),
         ps._F_IN_FOLD, 3, "force"),
        ("pq_pressure", ps._press_pq_pair(k), ps._PQ_IN, 3, "pressure"),
        ("force_vjp", ps._bwd_pair(ps._force_pair(k, p.mass, p.mu), 3,
                                   ps._F_GRAD),
         ps._F_IN + ("ct_0", "ct_1", "ct_2"), len(ps._F_GRAD), "force"),
    ]
    for name, pair, names, n_out, kind in cases:
        ins = [planes[c] for c in names]
        prod = jax.jit(lambda *a, pair=pair, names=names, n_out=n_out,
                       kind=kind: ps._sweep(pair, names, n_out, a, spec,
                                            kind=kind))
        ref = jax.jit(lambda *a, pair=pair, names=names, n_out=n_out:
                      ps._sweep_xla(pair, names, n_out, a, spec))
        out, ms = _timed(prod, *ins)
        want = ref(*ins)
        errs = [float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
                for a, b in zip(out, want)]
        assert all(np.isfinite(errs)) and max(errs) <= _SWEEP_TOL, (name, errs)
        say("b", f"sweep {name} at {spec.plane_shape}: {ms:.3f} ms, max "
                 f"rel err vs _sweep_xla {max(errs):.2e} (tol {_SWEEP_TOL})")
    return sim


def phase_b_step(n3: int, steps: int = 5) -> None:
    """The compiled 1M steps hold the Triton sweeps; warm ms/step."""
    for solver in ("wcsph", "pcisph"):
        sim = _dam_break(n3, solver)
        n = sim.state.pos.shape[0]
        compiled = jax.jit(sim.step_fn).lower(sim.state).compile()
        hlo = compiled.as_text()
        n_tri = hlo.count("xla.gpu.triton")
        assert n_tri >= 2, f"compiled {solver} step holds no Triton sweep"
        mem = compiled.memory_analysis()
        st, _ = jax.block_until_ready(compiled(sim.state))
        t0 = time.perf_counter()
        for _ in range(steps):
            st, diag = compiled(st)
        jax.block_until_ready(st)
        ms = (time.perf_counter() - t0) / steps * 1e3
        say("b", f"compiled {n}-particle {solver} step: {n_tri} Triton "
                 f"custom calls; temp {mem.temp_size_in_bytes / 2**30:.2f} "
                 f"GiB; {ms:.3f} ms/step over steps 2-{steps + 1}")


def phase_b_reference(n3: int) -> None:
    """Dense path vs the plain XLA cell-grid path on one state."""
    from dieselfluid_tpu.neighbors.cellgrid import (CellGridSpec,
                                                    cell_grid_neighborhood)
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers.dense_step import dense_density_forces
    from dieselfluid_tpu.solvers.wcsph import compute_forces

    rsim = _dam_break(n3)
    key = jax.random.PRNGKey(1)
    rp, rcfg = rsim.params, rsim.config
    st = rsim.state._replace(vel=jax.random.normal(
        key, rsim.state.pos.shape) * 0.1)
    dspec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), rp.h,
                                     capacity=rcfg.cell_capacity)
    cspec = CellGridSpec.for_domain((-1, -1, -1), (1, 1, 1), rp.h,
                                    capacity=rcfg.cell_capacity)
    rho_d, _, f_d, ovf = jax.jit(
        lambda s: dense_density_forces(s, rp, dspec))(st)
    ref = jax.jit(lambda s: compute_forces(s, cell_grid_neighborhood(
        s.pos, s.pos, rp.h, rcfg.max_neighbors, cspec), rp))(st)
    f_x = ref.force - jnp.asarray(rp.gravity, jnp.float32) * rp.mass
    rho_err = float(jnp.max(jnp.abs(rho_d - ref.density) / ref.density))
    f_err = float(jnp.max(jnp.abs(f_d - f_x)) / jnp.max(jnp.abs(f_x)))
    assert int(ovf) == 0, int(ovf)
    # fp32, different summation order over ~33 neighbours per particle.
    assert rho_err <= 1e-4 and f_err <= 1e-4, (rho_err, f_err)
    say("b", f"dense vs cell-grid at {st.pos.shape[0]}: density max rel err "
             f"{rho_err:.2e}, force err {f_err:.2e} of max |f| (tol 1e-4)")


def _cli(phase: str, argv) -> dict:
    from dieselfluid_tpu.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    assert rc == 0, rc
    summary = json.loads(lines[-1])
    say(phase, f"cli {' '.join(argv)}: {lines[-1]}")
    return summary


def phase_c(n3: int, out: str) -> None:
    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density

    dx = 2.0 / n3 * 0.5
    c = _sound_speed(lattice_rest_density(dx, FluidParams.for_spacing(dx)))
    for solver, steps in (("wcsph", 20), ("pcisph", 10)):
        d = os.path.join(out, solver)
        s = _cli("c", ["--neighbors", "dense", "--solver", solver,
                       "--n3", str(n3), "--steps", str(steps),
                       "--render-every", str(steps - 1), "--out", d])
        traj = np.load(s["outputs"]["npz"])["positions"]
        y0, y1 = float(traj[0, :, 1].mean()), float(traj[-1, :, 1].mean())
        assert s["overflow"] == 0, s["overflow"]
        assert np.isfinite(traj).all()
        assert np.isfinite(s["max_vel"]) and s["max_vel"] < c, (s["max_vel"],
                                                                c)
        assert y1 < y0, (y0, y1)
        say("c", f"{solver}: finite, overflow 0, max|v| {s['max_vel']:.4f} "
                 f"< c {c:.1f}, mean y {y0:.6f} -> {y1:.6f}")
    s = _cli("c", ["--neighbors", "dense", "--n3", str(n3), "--steps", "1",
                   "--render", "--size", "1080", "--out",
                   os.path.join(out, "render")])
    assert np.isfinite(s["max_vel"]) and s["overflow"] == 0, s
    say("c", "render: one 1080x1080 frame")


def phase_d(n3: int) -> None:
    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers.dense_resident import (
        dense_wcsph_resident_step, plane_state_from_fluid)

    dx = 2.0 / n3 * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    state = dam_break_state(n3, params, extent=0.5)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                    params.h, capacity=16)
    ps = jax.jit(lambda s: plane_state_from_fluid(s, spec))(state)
    step = jax.jit(lambda q: dense_wcsph_resident_step(q, params, spec,
                                                       skin=0.05))
    ps = jax.block_until_ready(step(ps))
    steps = 40
    t0 = time.perf_counter()
    for _ in range(steps):
        ps = step(ps)
    jax.block_until_ready(ps)
    ms = (time.perf_counter() - t0) / steps * 1e3
    x = ps.planes["x"]
    assert bool(jnp.isfinite(x).all()), "non-finite planes"
    assert int(ps.overflow) == 0, int(ps.overflow)
    say("d", f"resident WCSPH {state.n} particles: {steps} steps "
             f"{ms:.3f} ms/step, {int(ps.rebuilds)} rebuilds, overflow 0")


def phase_e(n3: int) -> None:
    from dieselfluid_tpu.models.materials import Materials
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step

    sim = _dam_break(n3, "pcisph")
    p = sim.params
    spec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), p.h,
                                    capacity=sim.config.cell_capacity)
    key = jax.random.PRNGKey(2)
    st = sim.state._replace(vel=jax.random.normal(
        key, sim.state.pos.shape) * 0.05)
    w = jax.random.normal(jax.random.fold_in(key, 1), st.pos.shape)

    def loss(m):
        nxt, _ = dense_pcisph_step(st, p, spec, sim.delta, materials=m,
                                   unroll_for_grad=True)
        return jnp.sum(nxt.pos * w)

    t0 = time.perf_counter()
    g = jax.block_until_ready(jax.jit(jax.grad(loss))(
        Materials.from_params(p)))
    vals = {f: float(getattr(g, f)) for f in g._fields}
    assert all(np.isfinite(v) for v in vals.values()), vals
    assert vals["mu"] != 0.0 and vals["d0"] != 0.0, vals
    say("e", f"grad through unrolled PCISPH at {st.n} particles "
             f"({time.perf_counter() - t0:.1f} s incl. compile): "
             + ", ".join(f"{k} {v:.4e}" for k, v in vals.items()))


def phase_f(n3: int) -> None:
    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.render.camera import Camera
    from dieselfluid_tpu.render.splat import splat_particles

    dx = 2.0 / n3 * 0.5
    state = dam_break_state(n3, FluidParams.for_spacing(dx), extent=0.5)
    cam = Camera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                    fov_deg=55.0, aspect=1920.0 / 1080.0)

    def loss(pos):
        img = splat_particles(pos, dx * 0.7, cam, width=1920, height=1080)
        return jnp.sum(img.color ** 2)

    g, ms = _timed(jax.jit(jax.grad(loss)), state.pos)
    gn = float(jnp.sum(g * g))
    assert np.isfinite(gn) and gn > 0.0, gn
    say("f", f"splat fwd+bwd {state.n} particles at 1920x1080: {ms:.3f} "
             f"ms/frame, |grad|^2 {gn:.4e}")


def _match(ref_pos, ref_vel, pos, vel, lo, hi, band):
    """(max position difference, max velocity difference off the walls,
    particles within `band` of a wall) after pairing each reference
    particle with its nearest sharded particle (the pairing must be a
    bijection: the decomposition permutes particles).

    A particle on a box wall is on a knife edge: position noise of 1e-7
    decides whether a step registers wall contact, which reflects its
    normal velocity and damps the tangential one by the friction factor
    (solvers.integrate.box_collide). So velocities are compared only away
    from the walls; positions everywhere."""
    from scipy.spatial import cKDTree

    d, idx = cKDTree(pos).query(ref_pos)
    assert len(np.unique(idx)) == len(ref_pos), "matching is not a bijection"
    walled = np.any((ref_pos - np.asarray(lo) < band)
                    | (np.asarray(hi) - ref_pos < band), axis=1)
    dv = np.abs(vel[idx] - ref_vel).max(axis=1)
    return float(d.max()), float(dv[~walled].max()), int(walled.sum())


def phase_four(n3: int, steps: int = 4) -> None:
    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.parallel.dense_halo import (
        DenseSlabSpec, distribute_dense, make_dense_halo_pcisph_step,
        make_dense_halo_wcsph_step)
    from dieselfluid_tpu.parallel.halo import collect
    from dieselfluid_tpu.parallel.sharding import particle_mesh
    from dieselfluid_tpu.solvers.dense_step import (dense_pcisph_step,
                                                    dense_wcsph_step)
    from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

    n_dev = 4
    assert len(jax.devices()) >= n_dev, jax.devices()
    dx = 2.0 / n3 * 0.5
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    delta = compute_pci_delta(params, dx)
    s0 = dam_break_state(n3, params, extent=0.5)
    # A downward slam so PCISPH takes more than one correction iteration
    # and every particle moves by many float ulps within the window.
    s0 = s0._replace(vel=s0.vel + jnp.asarray([0.0, -1.0, 0.0]))
    spec = DenseSlabSpec.build_for_state(s0, n_dev, params.h,
                                         migrate_capacity=8192,
                                         cell_capacity=32)
    gspec = DenseCellSpec.for_domain(
        (spec.lo, spec.lo, spec.lo),
        (spec.hi_x, spec.hi_yz, spec.hi_yz + 3.0 * spec.cell),
        spec.cell, capacity=spec.cell_capacity)
    bounds = ((spec.lo,) * 3, (spec.hi_x, spec.hi_yz, spec.hi_yz))
    mesh = particle_mesh(n_dev)
    # The two paths sum the same pair terms in different orders (the slab
    # binning permutes particles within a cell), and the PCISPH loop may
    # exit one iteration apart on float noise: 1% of the lattice spacing in
    # position, 1e-2 in velocity (the slam is 1). Wall band for the
    # velocity check (see _match): two steps of travel at the slam speed.
    pos_tol, vel_tol, band = 0.01 * dx, 1e-2, 2.0 * params.dt
    lo, hi = bounds

    solvers = {
        "wcsph": (lambda s: dense_wcsph_step(s, params, gspec,
                                             bounds=bounds),
                  make_dense_halo_wcsph_step(mesh, spec, params)),
        "pcisph": (lambda s: dense_pcisph_step(s, params, gspec, delta,
                                               bounds=bounds),
                   make_dense_halo_pcisph_step(mesh, spec, params, delta)),
    }
    for name, (single, sharded) in solvers.items():
        # Warm-up, untimed: the first sharded call compiles for host-placed
        # slabs, the second for mesh-committed ones.
        jax.block_until_ready(single(single(s0)[0]))
        jax.block_until_ready(sharded(sharded(distribute_dense(s0, spec))[0]))
        s = s0
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            s, diag = single(s)
            jax.block_until_ready(s.pos)
            times.append(time.perf_counter() - t0)
            assert int(diag.overflow) == 0, int(diag.overflow)
        t_single = np.mean(times) * 1e3
        slabs = distribute_dense(s0, spec)
        assert float(slabs.dropped) == 0.0
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            slabs, max_vel, n_live, ovf, per_slab = jax.block_until_ready(
                sharded(slabs))
            times.append(time.perf_counter() - t0)
            assert int(n_live) == s0.n, (int(n_live), s0.n)
            assert int(ovf) == 0 and float(slabs.dropped) == 0.0
        t_shard = np.mean(times) * 1e3
        pos_sh, vel_sh = collect(slabs)
        dpos, dvel, walled = _match(np.asarray(s.pos), np.asarray(s.vel),
                                    pos_sh, vel_sh, lo, hi, band)
        say("four", f"{name} {s0.n} particles, {steps} steps on "
                    f"{n_dev} GPUs: n_live {int(n_live)}, overflow 0, "
                    f"dropped 0, per-slab {np.asarray(per_slab).tolist()}; "
                    f"vs one GPU max |dpos| {dpos:.2e} (tol {pos_tol:.0e}), "
                    f"max |dvel| {dvel:.2e} (tol {vel_tol:.0e}) off the "
                    f"walls ({walled} particles within {band:.0e} of one); "
                    f"ms/step (warm) 4 GPUs {t_shard:.3f}, one GPU "
                    f"{t_single:.3f}")
        assert dpos <= pos_tol and dvel <= vel_tol, (name, dpos, dvel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU slab-decomposed phase")
    ap.add_argument("--n3", type=int, default=100,
                    help="dam-break cube root for phases b, c, d and --four")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from dieselfluid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    phase_a()
    if args.four:
        phase_four(args.n3)
    else:
        out = os.path.join(_ROOT, "out", "chip_smoke")
        phase_b_sweeps(args.n3)
        phase_b_step(args.n3)
        phase_b_reference(_N3_SMALL)
        phase_c(args.n3, out)
        shutil.rmtree(out, ignore_errors=True)
        phase_d(args.n3)
        phase_e(_N3_SMALL)
        phase_f(_N3_SPLAT)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
