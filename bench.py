"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline metric: particle-steps/sec per device at 1M particles on the
plane-resident dense WCSPH pipeline, synchronized on a device-reduced
scalar. vs_baseline normalizes against a 1M particle-steps/sec target.

TIME BUDGET: the default run measures the two 1M headline configs, PRINTS
THE HEADLINE LINE IMMEDIATELY, then runs secondary entries only while
wall-clock remains under DSLTPU_BENCH_BUDGET_S (default 480 s).
BENCH_DETAILS.json is merge-flushed after EVERY entry, so a kill mid-run
loses at most one entry, never the headline. `python bench.py --full` runs
everything (8M scale, phase breakdown, composite, materials-grad) with no
budget.

There is no fallback: if a headline path fails, the traceback propagates
and the script exits nonzero.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

import numpy as np

from dieselfluid_tpu.utils.compile_cache import enable_compile_cache

TARGET_PSTEPS_PER_SEC = 1.0e6
T_START = time.time()


def elapsed() -> float:
    return time.time() - T_START


def bench_dense_wcsph(n3: int, steps: int, capacity: int = 16,
                      windows: int = 3):
    import jax

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step

    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, extent=extent)
    # Equilibrium lattice d0 (see bench_dense_pcisph): the old 1.1x
    # inflation compressed the whole column until impact transiently
    # overflowed capacity 16 (6 particles at step 125 of a 1M guarded soak).
    params = lattice_rest_density(dx, params)
    # Quarter-cell domain offset: lattice planes sit mid-cell, so float
    # rounding at cell boundaries cannot spill whole planes over capacity.
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=capacity)
    step = jax.jit(lambda s: dense_wcsph_step(s, params, spec))

    import jax.numpy as jnp

    # Hard sync via a DEVICE-REDUCED scalar: fetching the full (N, 3) pos
    # array would time the host transfer, not the device.
    sync = jax.jit(lambda s: jnp.sum(s.pos))

    s, diag = step(state)
    float(sync(s))                         # compile + first step
    overflow = [diag.overflow]
    # Median of timed windows with spread — a single window is not a
    # number.
    wins = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            s, diag = step(s)
            overflow.append(diag.overflow)
        float(sync(s))                     # hard sync (scalar fetch)
        wins.append(time.perf_counter() - t0)
    # Device-side finiteness (|pos| <= box, so a finite sum == all finite;
    # NaN/inf propagate): the full-array fetch is 96 MB at 8M.
    assert np.isfinite(float(jax.jit(
        lambda st: jnp.sum(jnp.abs(st.pos)))(s))), "non-finite trajectory"
    n = s.pos.shape[0]
    dt = float(np.median(wins))
    return {"n": n, "steps": steps, "ms_per_step": dt / steps * 1e3,
            "psteps_per_sec": n * steps / dt,
            "psteps_per_sec_min": n * steps / max(wins),
            "psteps_per_sec_max": n * steps / min(wins),
            "max_overflow": int(np.max(np.asarray(overflow)))}


def bench_dense_wcsph_resident(n3: int, steps: int, capacity: int = 16,
                               windows: int = 3, skin: float = 0.05,
                               burnin: int = 60):
    """The PLANE-RESIDENT production WCSPH path: state lives in the dense
    planes across frames and the binning is rebuilt only when accumulated
    displacement exceeds the skin (the analog of the reference's
    cache-extinction neighbor schedule, ref: model/sph/fluid.go:208-215).

    `burnin` untimed steps first so the timed windows sit in the agitated
    dam-break regime where rebuilds actually fire (a from-lattice window has
    none and would overstate the amortization). Rebuild count is reported
    so the number cannot hide a never-rebuilding window."""
    import jax
    import jax.numpy as jnp

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers.dense_resident import (
        dense_wcsph_resident_step,
        plane_state_from_fluid,
    )

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, extent=extent)
    params = lattice_rest_density(dx, params)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=capacity)
    ps = jax.jit(lambda s: plane_state_from_fluid(s, spec),
                 static_argnames=())(state)
    step = jax.jit(lambda p: dense_wcsph_resident_step(p, params, spec,
                                                       skin=skin))
    sync = jax.jit(lambda p: jnp.sum(p.planes["x"]))

    ps = step(ps)
    float(sync(ps))
    for _ in range(burnin):
        ps = step(ps)
    float(sync(ps))
    rb0 = int(ps.rebuilds)
    wins = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            ps = step(ps)
        float(sync(ps))
        wins.append(time.perf_counter() - t0)
    assert np.isfinite(float(jax.jit(
        lambda p: jnp.sum(jnp.abs(p.planes["x"])))(ps)))
    n = int(state.pos.shape[0])
    dt = float(np.median(wins))
    return {"n": n, "steps": steps, "burnin": burnin,
            "window": f"steps {burnin + 2}-{burnin + 1 + windows * steps} "
                      "of a dam break",
            "ms_per_step": dt / steps * 1e3,
            "psteps_per_sec": n * steps / dt,
            "psteps_per_sec_min": n * steps / max(wins),
            "psteps_per_sec_max": n * steps / min(wins),
            "skin": skin,
            "rebuilds_in_windows": int(ps.rebuilds) - rb0,
            "rebuilds": int(ps.rebuilds),
            "total_steps": int(ps.age_total),
            "max_overflow": int(ps.overflow)}


def bench_dense_pcisph_resident(n3: int, steps: int, capacity: int = 16,
                                burnin: int = 30, skin: float = 0.05):
    """PCISPH, plane-resident across frames (solvers.dense_resident): the
    per-frame binning + 6-channel rebuild + gathers amortize onto the
    displacement-triggered rebuild schedule. Same burn-in discipline as
    bench_dense_pcisph; rebuild count reported."""
    import jax
    import jax.numpy as jnp

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers.dense_resident import (
        dense_pcisph_resident_step,
        plane_state_from_fluid,
    )
    from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, extent=extent)
    params = lattice_rest_density(dx, params)
    delta = compute_pci_delta(params, dx)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=capacity)
    ps = jax.jit(lambda s: plane_state_from_fluid(s, spec))(state)
    step = jax.jit(lambda p: dense_pcisph_resident_step(
        p, params, spec, delta, skin=skin, warm_start=True))
    sync = jax.jit(lambda p: jnp.sum(p.planes["x"]))

    ps, it = step(ps)
    float(sync(ps))
    for _ in range(burnin):
        ps, it = step(ps)
    float(sync(ps))
    rb0 = int(ps.rebuilds)
    iters = []
    t0 = time.perf_counter()
    for _ in range(steps):
        ps, it = step(ps)
        iters.append(it)
    float(sync(ps))
    dt = time.perf_counter() - t0
    assert np.isfinite(float(jax.jit(
        lambda p: jnp.sum(jnp.abs(p.planes["x"])))(ps)))
    n = int(state.pos.shape[0])
    return {"n": n, "steps": steps, "burnin": burnin,
            "window": f"steps {burnin + 2}-{burnin + 1 + steps} of a dam break",
            "ms_per_step": dt / steps * 1e3,
            "psteps_per_sec": n * steps / dt,
            "skin": skin,
            "rebuilds_in_window": int(ps.rebuilds) - rb0,
            "max_overflow": int(ps.overflow),
            "mean_iters": float(np.mean(np.asarray(iters)))}


def bench_dense_pcisph(n3: int, steps: int, capacity: int = 16,
                       burnin: int = 40):
    """PCISPH on the dense pipeline.

    `burnin` untimed steps first: a dam break started from the lattice is
    quiescent (mean_iters ~1.2) for its first ~30 steps, which would flatter
    the number. The timed window starts at step `burnin` (agitated regime;
    report mean_iters so the regime is visible).

    d0 is the equilibrium lattice density (neighbors.calibrate): an inflated
    d0 makes the correction loop compress the ENTIRE column toward a denser
    rest state — every step runs all 5 iterations and the densest cells
    eventually overflow any capacity. At equilibrium the loop converges
    and capacity 16 (2x lattice headroom, same layout as the WCSPH headline)
    holds with zero overflow. warm_start carries pressure across frames
    (production config; the reference resets Press each frame)."""
    import jax

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step
    from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, extent=extent)
    params = lattice_rest_density(dx, params)
    delta = compute_pci_delta(params, dx)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=capacity)
    step = jax.jit(lambda s: dense_pcisph_step(s, params, spec, delta,
                                               warm_start=True))

    import jax.numpy as jnp

    sync = jax.jit(lambda s: jnp.sum(s.pos))   # scalar sync (see above)
    s, diag = step(state)
    float(sync(s))                         # compile + first step
    overflow = [diag.overflow]
    for _ in range(burnin):
        s, diag = step(s)
        overflow.append(diag.overflow)
    float(sync(s))                         # burn-in complete, hard sync
    iters = []
    t0 = time.perf_counter()
    for _ in range(steps):
        s, diag = step(s)
        overflow.append(diag.overflow)
        iters.append(diag.iters)
    float(sync(s))
    dt = time.perf_counter() - t0
    assert np.isfinite(float(jax.jit(
        lambda st: jnp.sum(jnp.abs(st.pos)))(s))), "non-finite trajectory"
    n = s.pos.shape[0]
    return {"n": n, "steps": steps, "burnin": burnin,
            "window": f"steps {burnin + 1}-{burnin + steps} of a dam break",
            "ms_per_step": dt / steps * 1e3,
            "psteps_per_sec": n * steps / dt,
            "max_overflow": int(np.max(np.asarray(overflow))),
            "mean_iters": float(np.mean(np.asarray(iters)))}


def bench_sim_render_fwd_bwd(n3: int = 80, frames: int = 3):
    """512k-particle dense WCSPH step -> 1080p differentiable splat render
    -> pixel loss -> gradients to the pre-step positions, all compiled on
    the device."""
    import jax
    import jax.numpy as jnp

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.render.camera import Camera
    from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, extent=extent)
    params = lattice_rest_density(dx, params)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=16)
    cam = Camera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                    fov_deg=55.0, aspect=1920.0 / 1080.0)
    target = jnp.zeros((1080, 1920, 3), jnp.float32)

    from dieselfluid_tpu.render.splat import splat_particles

    def loss(pos):
        st = state._replace(pos=pos)
        nxt, _ = dense_wcsph_step(st, params, spec)
        img = splat_particles(nxt.pos, dx * 0.7, cam, width=1920,
                              height=1080)
        return jnp.sum((img.color - target) ** 2)

    g = jax.jit(jax.grad(loss))
    gv = g(state.pos)
    gnorm = float(np.asarray(jnp.sum(gv * gv)))     # scalar sync, not 6 MB
    assert np.isfinite(gnorm), gnorm
    t0 = time.perf_counter()
    for _ in range(frames):
        gv = g(state.pos)
    float(np.asarray(jnp.sum(gv * gv)))
    dt = time.perf_counter() - t0
    return {"n": state.pos.shape[0], "frames": frames,
            "fwd_bwd_ms_per_frame": dt / frames * 1e3,
            "grad_norm_sq": gnorm}


def bench_pcisph_materials_grad_1m(n3: int = 100, frames: int = 2):
    """1M-particle dense PCISPH step (fixed-iteration reverse-mode scan) ->
    sky-lit splat render -> pixel loss -> gradients to the MATERIAL
    parameters (viscosity, rest density, mass) and the pre-step positions,
    compiled on the device."""
    import jax
    import jax.numpy as jnp

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.materials import Materials
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import DenseCellSpec
    from dieselfluid_tpu.render.camera import Camera
    from dieselfluid_tpu.sky.bake import bake_sky_cubemap
    from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step
    from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, extent=extent)
    # Small random velocities: at rest the viscosity force is identically
    # zero and d(loss)/d(mu) is a trivial 0 — perturb so the mu gradient is
    # actually exercised.
    import jax as _jax
    import jax.numpy as _jnp

    state = state._replace(vel=_jax.random.normal(
        _jax.random.PRNGKey(2), state.vel.shape, _jnp.float32) * 0.05)
    params = lattice_rest_density(dx, params)
    delta = compute_pci_delta(params, dx)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=16)
    mats = Materials.from_params(params)
    env = bake_sky_cubemap((0.3, 0.8, 0.5), size=48)
    cam = Camera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                    fov_deg=55.0, aspect=1920.0 / 1080.0)
    target = jnp.zeros((1080, 1920, 3), jnp.float32)

    from dieselfluid_tpu.render.splat import splat_particles

    def loss(m, pos):
        st = state._replace(pos=pos)
        # unroll_iters=3: the adaptive while_loop's sustained mean is 2.84
        # iterations on this regime (see dense_pcisph_1m) — the unrolled
        # reverse-differentiable scan matches the observed count instead of
        # always paying the 5-iteration cap.
        nxt, _ = dense_pcisph_step(st, params, spec, delta, materials=m,
                                   unroll_for_grad=True, unroll_iters=3)
        img = splat_particles(nxt.pos, dx * 0.7, cam, width=1920,
                              height=1080, env_cube=env)
        return jnp.sum((img.color - target) ** 2)

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))
    gm, gp = g(mats, state.pos)
    checks = {f: float(np.asarray(getattr(gm, f))) for f in ("mu", "d0", "mass")}
    gpn = float(np.asarray(jnp.sum(gp * gp)))
    assert all(np.isfinite(v) for v in checks.values()), checks
    assert np.isfinite(gpn), gpn
    t0 = time.perf_counter()
    for _ in range(frames):
        gm, gp = g(mats, state.pos)
    float(np.asarray(gm.mu))
    dt = time.perf_counter() - t0
    return {"n": state.pos.shape[0], "frames": frames,
            "fwd_bwd_ms_per_frame": dt / frames * 1e3,
            "material_grads": checks, "grad_pos_norm_sq": gpn}


def bench_composite_1080p(n3: int = 80, frames: int = 3):
    """Full composited frame at 1080p, fwd+bwd: 512k fluid splats LIT BY the
    baked CIE sky cubemap (SH9 environment lighting), over a ray-traced floor+wall scene, soft depth test, pixel loss, gradients
    to particle positions."""
    import jax
    import jax.numpy as jnp

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.render.camera import Camera
    from dieselfluid_tpu.render.composite import render_composite
    from dieselfluid_tpu.render.pbr import PBRMaterial
    from dieselfluid_tpu.sky.bake import bake_sky_cubemap

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    state = dam_break_state(n3, params, extent=extent)

    # Procedural scene: floor (y=-1) + back wall (z=1), 4 triangles.
    v = np.asarray([
        [-2, -1, -2], [2, -1, -2], [2, -1, 2],
        [-2, -1, -2], [2, -1, 2], [-2, -1, 2],
        [-2, -1, 1], [2, -1, 1], [2, 2, 1],
        [-2, -1, 1], [2, 2, 1], [-2, 2, 1],
    ], np.float32).reshape(4, 3, 3)
    tris = jnp.asarray(v)
    norms = jnp.asarray([[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1]],
                        jnp.float32)
    mats = jnp.zeros((4,), jnp.int32)
    materials = jax.tree.map(
        lambda leaf: leaf[None],
        PBRMaterial.make(base_color=(0.55, 0.5, 0.45), metallic=0.05,
                         roughness=0.7))
    env = bake_sky_cubemap((0.3, 0.8, 0.5), size=48)
    cam = Camera.at((0.0, 0.6, -2.8), front=(0.0, -0.35, 1.0),
                    fov_deg=55.0, aspect=1920.0 / 1080.0)
    target = jnp.zeros((1080, 1920, 3), jnp.float32)

    def loss(pos):
        img = render_composite(pos, dx * 0.7, cam, tris, norms, mats,
                               materials, light_pos=(2.0, 3.0, -2.0),
                               env_cube=env, width=1920, height=1080)
        return jnp.sum((img.color - target) ** 2)

    g = jax.jit(jax.grad(loss))
    gv = g(state.pos)
    gnorm = float(np.asarray(jnp.sum(gv * gv)))
    assert np.isfinite(gnorm), gnorm
    t0 = time.perf_counter()
    for _ in range(frames):
        gv = g(state.pos)
    float(np.asarray(jnp.sum(gv * gv)))
    dt = time.perf_counter() - t0
    return {"n": state.pos.shape[0], "frames": frames,
            "fwd_bwd_ms_per_frame": dt / frames * 1e3,
            "grad_norm_sq": gnorm}


def bench_phases_dense_1m(n3: int = 100, reps: int = 5):
    """Phase breakdown of the dense WCSPH step at 1M: binning, plane build,
    density sweep, fused force sweep and gather, each timed alone with
    device-reduced scalars."""
    import jax
    import jax.numpy as jnp

    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.ops.cellops import (DenseCellSpec, build_planes,
                                             dense_indices, gather_planes)
    from dieselfluid_tpu.ops.pallas_sph import density_planes, force_planes
    from dieselfluid_tpu.ops.smoothing import KernelCoeffs, tait_eos

    extent = 0.5
    dx = (2.0 / n3) * extent
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    state = dam_break_state(n3, params, extent=extent)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3, params.h,
                                    capacity=16)
    k = KernelCoeffs.build(params.h)
    pos, vel = state.pos, state.vel

    def timed(fn, *args):
        jfn = jax.jit(fn)
        np.asarray(jfn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = jfn(*args)
        np.asarray(out)
        return (time.perf_counter() - t0) / reps * 1e3

    flat, valid, _ = jax.jit(lambda p: dense_indices(p, spec))(pos)
    chans = lambda p, v: {"x": p[:, 0], "y": p[:, 1], "z": p[:, 2],
                          "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2]}
    planes = jax.jit(lambda p, v, f, va: build_planes(chans(p, v), f, va,
                                                      spec))(pos, vel, flat,
                                                             valid)
    rho_plane = jax.jit(
        lambda pl_: density_planes(pl_, spec, k, params.mass))(planes)
    press_plane = jax.jit(lambda rp, m: jnp.where(
        m > 0, tait_eos(rp, params.d0, params.p0, params.tait_gamma,
                        params.tait_w), 0.0))(rho_plane, planes["mask"])

    phases = {
        "binning_ms": timed(lambda p: dense_indices(p, spec)[0].sum(), pos),
        "build_planes_ms": timed(
            lambda p, v, f, va: sum(x.sum() for x in build_planes(
                chans(p, v), f, va, spec).values()), pos, vel, flat, valid),
        "density_sweep_ms": timed(
            lambda pl_: density_planes(pl_, spec, k, params.mass).sum(),
            planes),
        "force_sweep_ms": timed(
            lambda pl_, rp, pp: sum(x.sum() for x in force_planes(
                pl_, rp, pp, spec, k, params.mass, float(params.mu))),
            planes, rho_plane, press_plane),
        "gather_ms": timed(
            lambda rp, pp, f: gather_planes([rp, pp, rp, pp, rp], f).sum(),
            rho_plane, press_plane, flat),
    }

    occupied_rows = float(jnp.sum(
        jnp.max(planes["mask"], axis=(1, 2)) > 0))  # live (x,y) columns
    return {"n": int(pos.shape[0]), "phases": phases,
            "live_row_fraction": round(occupied_rows / spec.rows, 4)}


DETAILS_PATH = __file__.replace("bench.py", "BENCH_DETAILS.json")


def flush_details(details: dict):
    """Merge-write BENCH_DETAILS.json after every entry (a single
    end-of-run dump leaves nothing when the process is killed). Entries from previous runs (e.g. --full verify
    sessions) persist unless re-measured."""
    try:
        with open(DETAILS_PATH) as f:
            merged = json.load(f)
    except (OSError, ValueError):
        merged = {}
    merged.update(details)
    try:
        with open(DETAILS_PATH, "w") as f:
            json.dump(merged, f, indent=1)
    except OSError:
        pass


def main():
    full = "--full" in sys.argv
    budget = float(os.environ.get("DSLTPU_BENCH_BUDGET_S", "480"))
    enable_compile_cache()
    details = {}

    def note(msg):
        print(f"[bench +{elapsed():.0f}s] {msg}", file=sys.stderr, flush=True)

    # ---- Headline entries (always run, printed the moment they're done) ----
    note("headline: dense 1M WCSPH (plane-resident)")
    head = bench_dense_wcsph_resident(n3=100, steps=10, windows=3)
    details["dense_1m_resident"] = head
    metric = ("wcsph particle-steps/sec (1,000,000 particles, dense "
              f"plane-resident, skin {head['skin']}, "
              f"{head['rebuilds_in_windows']} rebuilds in the "
              f"{head['window']})")
    value = head["psteps_per_sec"]
    flush_details(details)

    note("headline: dense 1M PCISPH sustained (plane-resident)")
    # 50 timed steps after a 30-step burn-in: the agitated regime
    # (mean_iters reported so the window is disclosed).
    pci = bench_dense_pcisph_resident(n3=100, steps=50, burnin=30)
    details["dense_pcisph_1m_resident"] = pci
    flush_details(details)

    # Both solvers' standing vs the 1M-psteps/s target in the headline.
    # Window and regime (mean correction iterations) stated so the number
    # cannot be mistaken for a quiescent-lattice run.
    metric += (f" | pcisph 1M sustained ({pci['steps']} steps after "
               f"{pci['burnin']}-step burn-in, mean_iters "
               f"{pci['mean_iters']:.2f}): "
               f"{pci['psteps_per_sec']:.0f} psteps/s "
               f"= {pci['psteps_per_sec'] / TARGET_PSTEPS_PER_SEC:.2f}x "
               f"target, overflow {pci['max_overflow']}")

    # THE one stdout JSON line — printed BEFORE the secondary entries so a
    # driver kill mid-secondary can never erase the headline again.
    print(json.dumps({
        "metric": metric,
        "value": round(value, 1),
        "unit": "particle-steps/sec",
        "vs_baseline": round(value / TARGET_PSTEPS_PER_SEC, 4),
    }), flush=True)

    # ---- Secondary entries: budget-gated unless --full ----
    # Each starts only while wall-clock remains under the budget.
    secondaries = [
        ("sim_render_512k_fwd_bwd_1080p", bench_sim_render_fwd_bwd, {}),
        ("dense_32k", bench_dense_wcsph, {"n3": 32, "steps": 30}),
        ("dense_262k", bench_dense_wcsph, {"n3": 64, "steps": 15}),
        ("phases_dense_1m", bench_phases_dense_1m, {}),
        ("composite_1080p_fwd_bwd", bench_composite_1080p, {}),
        ("dense_8m", bench_dense_wcsph, {"n3": 200, "steps": 5, "windows": 1}),
        ("dense_pcisph_8m", bench_dense_pcisph,
         {"n3": 200, "steps": 10, "burnin": 0}),
        # The longest compiles last: 1M materials-grad (unrolled PCISPH
        # fwd+bwd + rasterizer bwd) and the 100-step PCISPH window.
        ("pcisph_materials_grad_1m", bench_pcisph_materials_grad_1m, {}),
        ("dense_pcisph_1m_100step", bench_dense_pcisph,
         {"n3": 100, "steps": 100, "burnin": 40}),
    ]
    for name, fn, kw in secondaries:
        if not full and elapsed() > budget:
            note(f"skip {name} (budget {budget:.0f}s spent)")
            details[name] = {"skipped": f"budget ({budget:.0f}s)"}
            flush_details(details)
            continue
        note(f"run {name}")
        try:
            details[name] = fn(**kw)
        except Exception as e:  # secondary metrics must not kill the headline
            traceback.print_exc()
            details[name] = {"error": repr(e)}
        flush_details(details)
    note("done")
    print(json.dumps(details, indent=1), file=sys.stderr)


if __name__ == "__main__":
    main()
