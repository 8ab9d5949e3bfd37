"""PLANE-RESIDENT WCSPH stepping: amortized neighbor-structure rebuilds.

The per-step dense pipeline (solvers.dense_step) pays ~89 of its ~190 ms at
1M particles re-binning particles and re-scattering all six channel planes
from scratch every frame (round-4 roofline: binning 18.8 + build_planes 54.0
+ gather 15.9 ms), even though the binning is identical frame-to-frame until
particles cross cell boundaries. Here the state LIVES in the dense planes
across frames: a step runs the two Pallas sweeps plus elementwise plane math
(EOS, integration, wall collision), and the binning is rebuilt only when the
accumulated per-particle displacement since the last rebuild exceeds a skin
threshold.

This is the analog of the reference's cache-extinction neighbor schedule
(ref: model/sph/fluid.go:208-215 — the LSH sampler is rebuilt only every
N-th frame), but displacement-triggered instead of fixed-period, so the
error is bounded by construction:

  With cell edge == support radius h, the 3x3x3 stencil finds every pair
  whose BINNED per-axis separation is < h. A pair currently at distance
  r <= h can be missed only if some axis separation grew past h since
  binning, i.e. only if m_i + m_j > h - r where m is displacement since the
  last rebuild. Rebuilding when max_i m_i >= skin*h therefore guarantees
  every pair with r <= (1 - 2*skin) h is found, and the missed shell
  carries cubic-spline weight O((2*skin)^3) of peak (W ~ (1-q)^3 near the
  support edge). At the default skin=0.05 that is <0.1% of peak kernel
  weight — far below the solver's own density tolerance — while the dam
  break's CFL-limited motion crosses the threshold only every several
  frames.

Overflowed particles (cell capacity) are NOT in the planes; they carry in
per-particle fallback arrays and integrate ballistically (gravity + walls),
matching dense_step's valid-mask fallback semantics, and rejoin the
structure at the next rebuild.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState
from dieselfluid_tpu.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_planes,
)
from dieselfluid_tpu.ops.pallas_sph import density_planes, force_planes
from dieselfluid_tpu.ops.smoothing import KernelCoeffs, tait_eos


class DensePlaneState(NamedTuple):
    """Cross-frame plane-resident solver state.

    planes: x/y/z/vx/vy/vz/mask dense planes (the live state).
    bnd: boundary-slot indicator plane (1.0 where a frozen boundary
         particle occupies the slot; those slots never integrate).
    ref_x/ref_y/ref_z: positions at the last rebuild (displacement skin).
    flat/valid: per-particle slot map from the last rebuild (fluid first,
         then boundary, as in dense_step._boundary_extended).
    fb_pos/fb_vel: ballistic fallback state for capacity-overflowed
         particles (don't-care rows where valid).
    boundary_pos: static boundary particle positions (None if none).
    overflow: max overflow seen at any rebuild; rebuilds/age_total: counters.
    """

    planes: Dict[str, jnp.ndarray]
    bnd: jnp.ndarray
    ref_x: jnp.ndarray
    ref_y: jnp.ndarray
    ref_z: jnp.ndarray
    flat: jnp.ndarray
    valid: jnp.ndarray
    fb_pos: jnp.ndarray
    fb_vel: jnp.ndarray
    boundary_pos: Optional[jnp.ndarray]
    overflow: jnp.ndarray
    rebuilds: jnp.ndarray
    age_total: jnp.ndarray


def _bin_and_build(pos, vel, n_fluid: int, spec: DenseCellSpec, press=None):
    """(planes, bnd, flat, valid, overflow) for fluid+boundary positions.

    `press` (per-particle, fluid+boundary) rides along as a plane channel so
    the PCISPH warm start survives rebuilds; zeros when absent."""
    flat, valid, overflow = dense_indices(pos, spec)
    is_bnd = (jnp.arange(pos.shape[0]) >= n_fluid).astype(jnp.float32)
    if press is None:
        press = jnp.zeros((pos.shape[0],), jnp.float32)
    planes = build_planes(
        {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
         "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2],
         "press": press, "bnd": is_bnd},
        flat, valid, spec,
    )
    bnd = planes.pop("bnd")
    return planes, bnd, flat, valid, overflow


def plane_state_from_fluid(state: FluidState,
                           spec: DenseCellSpec) -> DensePlaneState:
    """Bin a FluidState into a fresh DensePlaneState (rebuild step zero)."""
    if state.boundary_pos is not None:
        b = state.boundary_pos
        pos = jnp.concatenate([state.pos, b], axis=0)
        vel = jnp.concatenate([state.vel, jnp.zeros_like(b)], axis=0)
        press = jnp.concatenate(
            [state.pressure, jnp.zeros((b.shape[0],), jnp.float32)])
    else:
        pos, vel, press = state.pos, state.vel, state.pressure
    planes, bnd, flat, valid, overflow = _bin_and_build(
        pos, vel, state.pos.shape[0], spec, press=press)
    return DensePlaneState(
        planes=planes, bnd=bnd,
        ref_x=planes["x"], ref_y=planes["y"], ref_z=planes["z"],
        flat=flat, valid=valid,
        fb_pos=state.pos, fb_vel=state.vel,
        boundary_pos=state.boundary_pos,
        overflow=overflow.astype(jnp.int32),
        rebuilds=jnp.int32(0), age_total=jnp.int32(0))


def fluid_state_from_planes(ps: DensePlaneState, n_fluid: int,
                            params: FluidParams,
                            spec: DenseCellSpec) -> FluidState:
    """Gather per-particle state back out of the planes (snapshots/IO).

    density/pressure are recomputed on demand elsewhere; here they gather as
    rest values (the resident loop keeps them in plane form only)."""
    flat_f, valid_f = ps.flat[:n_fluid], ps.valid[:n_fluid]
    out = gather_planes([ps.planes["x"], ps.planes["y"], ps.planes["z"],
                         ps.planes["vx"], ps.planes["vy"], ps.planes["vz"]],
                        flat_f)
    pos = jnp.where(valid_f[:, None], out[:, 0:3], ps.fb_pos)
    vel = jnp.where(valid_f[:, None], out[:, 3:6], ps.fb_vel)
    n = pos.shape[0]
    return FluidState(
        pos=pos, vel=vel,
        force=jnp.broadcast_to(
            jnp.asarray(params.gravity, jnp.float32) * params.mass,
            pos.shape).astype(pos.dtype),
        density=jnp.full((n,), params.d0, jnp.float32),
        pressure=jnp.zeros((n,), jnp.float32),
        boundary_pos=ps.boundary_pos)


def _collide_axis(x, v, lo, hi, restitution):
    hit = (x < lo) | (x > hi)
    return jnp.clip(x, lo, hi), jnp.where(hit, -restitution * v, v), hit


@partial(jax.jit, static_argnames=("params", "spec", "skin", "bounds",
                                   "restitution", "friction"))
def dense_wcsph_resident_step(
    ps: DensePlaneState,
    params: FluidParams,
    spec: DenseCellSpec,
    skin: float = 0.05,
    bounds: Optional[Tuple] = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    restitution: float = 0.3,
    friction: float = 0.1,
) -> DensePlaneState:
    """One WCSPH frame, fully plane-resident.

    Semantics match dense_step.dense_wcsph_step exactly on steps where the
    displacement trigger fires (rebuild == fresh binning at current
    positions, which is what the per-step path does every frame); between
    rebuilds the binning is frozen and forces are exact for all pairs within
    (1 - 2*skin) h (see module docstring). skin=0.0 rebuilds every step
    (bitwise parity mode, used by the tests)."""
    mass, mu, d0 = params.mass, float(params.mu), params.d0
    k = KernelCoeffs.build(params.h)
    planes = ps.planes
    occ = planes["mask"] > 0
    fluid_occ = occ & (ps.bnd == 0)

    # --- sweeps (the only non-elementwise work on a non-rebuild step) ---
    rho_plane = density_planes(planes, spec, k, mass)
    press_plane = jnp.where(
        occ, tait_eos(rho_plane, d0, params.p0, params.tait_gamma,
                      params.tait_w), 0.0)
    fx, fy, fz = force_planes(planes, rho_plane, press_plane, spec, k,
                              mass, mu)

    # --- elementwise integrate + wall collide, in plane form ---
    g = jnp.asarray(params.gravity, jnp.float32)
    dt = params.dt
    lo, hi = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)) if bounds is None else bounds
    new_pos, new_vel, hits = [], [], []
    for ax, (xn, vn, fpl) in enumerate((("x", "vx", fx), ("y", "vy", fy),
                                        ("z", "vz", fz))):
        v = planes[vn] + (fpl / mass + g[ax]) * dt
        x = planes[xn] + v * dt
        if bounds is not None:
            x, v, hit = _collide_axis(x, v, lo[ax], hi[ax], restitution)
            hits.append(hit)
        new_pos.append(x)
        new_vel.append(v)
    if bounds is not None:
        any_hit = hits[0] | hits[1] | hits[2]
        for ax in range(3):
            new_vel[ax] = jnp.where(any_hit & ~hits[ax],
                                    (1.0 - friction) * new_vel[ax],
                                    new_vel[ax])
    np_ = {}
    for ax, (xn, vn) in enumerate((("x", "vx"), ("y", "vy"), ("z", "vz"))):
        np_[xn] = jnp.where(fluid_occ, new_pos[ax], planes[xn])
        np_[vn] = jnp.where(fluid_occ, new_vel[ax], planes[vn])
    np_["mask"] = planes["mask"]
    np_["press"] = planes["press"]   # carried (PCISPH warm start channel)

    # --- ballistic fallback for overflowed particles (gravity + walls) ---
    fb_vel = ps.fb_vel + g * dt
    fb_pos = ps.fb_pos + fb_vel * dt
    if bounds is not None:
        lo_a = jnp.asarray(lo, jnp.float32)
        hi_a = jnp.asarray(hi, jnp.float32)
        fhit = (fb_pos < lo_a) | (fb_pos > hi_a)
        fany = jnp.any(fhit, axis=-1, keepdims=True)
        fb_pos = jnp.clip(fb_pos, lo_a, hi_a)
        fb_vel = jnp.where(fhit, -restitution * fb_vel, fb_vel)
        fb_vel = jnp.where(fany & ~fhit, (1.0 - friction) * fb_vel, fb_vel)

    # --- displacement trigger ---
    disp = jnp.maximum(jnp.maximum(jnp.abs(np_["x"] - ps.ref_x),
                                   jnp.abs(np_["y"] - ps.ref_y)),
                       jnp.abs(np_["z"] - ps.ref_z))
    max_disp = jnp.max(jnp.where(fluid_occ, disp, 0.0))
    need = max_disp >= jnp.float32(skin * params.h)

    n_fluid = ps.fb_pos.shape[0]

    def do_rebuild(op):
        np_p, fbp, fbv = op
        out = gather_planes([np_p["x"], np_p["y"], np_p["z"],
                             np_p["vx"], np_p["vy"], np_p["vz"],
                             np_p["press"]],
                            ps.flat[:n_fluid])
        valid_f = ps.valid[:n_fluid]
        pos_f = jnp.where(valid_f[:, None], out[:, 0:3], fbp)
        vel_f = jnp.where(valid_f[:, None], out[:, 3:6], fbv)
        press_f = jnp.where(valid_f, out[:, 6], 0.0)
        if ps.boundary_pos is not None:
            nb = ps.boundary_pos.shape[0]
            pos = jnp.concatenate([pos_f, ps.boundary_pos], axis=0)
            vel = jnp.concatenate([vel_f, jnp.zeros_like(ps.boundary_pos)],
                                  axis=0)
            press = jnp.concatenate([press_f, jnp.zeros((nb,), jnp.float32)])
        else:
            pos, vel, press = pos_f, vel_f, press_f
        planes2, bnd2, flat2, valid2, ovf2 = _bin_and_build(
            pos, vel, n_fluid, spec, press=press)
        return (planes2, bnd2, planes2["x"], planes2["y"], planes2["z"],
                flat2, valid2, pos_f, vel_f,
                jnp.maximum(ps.overflow, ovf2.astype(jnp.int32)),
                ps.rebuilds + 1)

    def keep(op):
        np_p, fbp, fbv = op
        return (np_p, ps.bnd, ps.ref_x, ps.ref_y, ps.ref_z,
                ps.flat, ps.valid, fbp, fbv, ps.overflow, ps.rebuilds)

    (planes3, bnd3, rx, ry, rz, flat3, valid3, fbp3, fbv3, ovf3,
     rb3) = jax.lax.cond(need, do_rebuild, keep, (np_, fb_pos, fb_vel))

    return DensePlaneState(
        planes=planes3, bnd=bnd3, ref_x=rx, ref_y=ry, ref_z=rz,
        flat=flat3, valid=valid3, fb_pos=fbp3, fb_vel=fbv3,
        boundary_pos=ps.boundary_pos, overflow=ovf3, rebuilds=rb3,
        age_total=ps.age_total + 1)


@partial(jax.jit, static_argnames=("params", "spec", "delta", "skin",
                                   "bounds", "warm_start", "restitution",
                                   "friction"))
def dense_pcisph_resident_step(
    ps: DensePlaneState,
    params: FluidParams,
    spec: DenseCellSpec,
    delta: float,
    skin: float = 0.05,
    bounds: Optional[Tuple] = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    warm_start: bool = True,
    restitution: float = 0.3,
    friction: float = 0.1,
):
    """One PCISPH frame, fully plane-resident across frames.

    The correction loop is dense_step.dense_pcisph_step's plane_loop (two
    sweeps + elementwise plane math per iteration, zero scatters/gathers);
    residency additionally removes the per-frame binning + 6-channel plane
    build + final gathers (~85 ms of the 506 ms frame at 1M, round-4
    roofline) — rebuilt only on the displacement trigger, like the WCSPH
    step above. Warm-started pressure lives in the `press` plane and
    survives rebuilds through the rebuild gather/scatter.

    Returns (new_ps, iters) — iters is the correction-iteration count
    (adaptive while_loop, diag parity with dense_pcisph_step).
    """
    from dieselfluid_tpu.ops.pallas_sph import (
        pressure_force_pq_planes,
        viscosity_force_planes,
    )

    mass, mu, d0 = params.mass, float(params.mu), params.d0
    k = KernelCoeffs.build(params.h)
    planes = ps.planes
    mask_p = planes["mask"]
    occ = mask_p > 0
    fluid_occ = occ & (ps.bnd == 0)
    g = jnp.asarray(params.gravity, jnp.float32)
    dt = params.dt

    # External forces at the unpredicted state: viscosity sweep + gravity.
    rho_plane = density_planes(planes, spec, k, mass)
    vx_p, vy_p, vz_p = viscosity_force_planes(planes, rho_plane, spec, k,
                                              mass, mu)
    extf = (vx_p + g[0] * mass, vy_p + g[1] * mass, vz_p + g[2] * mass)
    vels = (planes["vx"], planes["vy"], planes["vz"])
    poss = (planes["x"], planes["y"], planes["z"])

    class _PC(NamedTuple):
        it: jnp.ndarray
        err: jnp.ndarray
        press_plane: jnp.ndarray
        fpx: jnp.ndarray
        fpy: jnp.ndarray
        fpz: jnp.ndarray

    def pbody(c: _PC) -> _PC:
        star = {}
        for ax, name in enumerate(("x", "y", "z")):
            accel = (extf[ax] + (c.fpx, c.fpy, c.fpz)[ax]) / mass
            xs = poss[ax] + (vels[ax] + accel * dt) * dt
            star[name] = jnp.where(fluid_occ, xs, poss[ax])
        star["mask"] = mask_p
        rho_star = density_planes(star, spec, k, mass)
        err = jnp.where(fluid_occ, rho_star - d0, 0.0)
        press = jnp.where(
            fluid_occ, jnp.maximum(c.press_plane + delta * err, 0.0), 0.0)
        rff = jnp.maximum(rho_star, 0.5 * d0)
        pq = jnp.where(fluid_occ, press / (rff * rff), 0.0)
        fx, fy, fz = pressure_force_pq_planes(planes, pq, spec, k, mass)
        return _PC(c.it + 1, jnp.max(err) / d0, press, fx, fy, fz)

    zero = jnp.zeros(spec.plane_shape, jnp.float32)
    press0 = (jnp.where(fluid_occ, planes["press"], 0.0) if warm_start
              else zero)
    init = _PC(it=jnp.int32(0), err=jnp.float32(jnp.inf), press_plane=press0,
               fpx=zero, fpy=zero, fpz=zero)
    cond = lambda c: (c.it < params.pci_max_iters) & (
        c.err > params.pci_max_density_error_ratio)
    c = jax.lax.while_loop(cond, pbody, init)

    # --- elementwise integrate + wall collide (WCSPH step's epilogue) ---
    lo, hi = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)) if bounds is None else bounds
    fps = (c.fpx, c.fpy, c.fpz)
    new_pos, new_vel, hits = [], [], []
    for ax in range(3):
        v = vels[ax] + ((extf[ax] + fps[ax]) / mass) * dt
        x = poss[ax] + v * dt
        if bounds is not None:
            x, v, hit = _collide_axis(x, v, lo[ax], hi[ax], restitution)
            hits.append(hit)
        new_pos.append(x)
        new_vel.append(v)
    if bounds is not None:
        any_hit = hits[0] | hits[1] | hits[2]
        for ax in range(3):
            new_vel[ax] = jnp.where(any_hit & ~hits[ax],
                                    (1.0 - friction) * new_vel[ax],
                                    new_vel[ax])
    np_ = {}
    for ax, (xn, vn) in enumerate((("x", "vx"), ("y", "vy"), ("z", "vz"))):
        np_[xn] = jnp.where(fluid_occ, new_pos[ax], planes[xn])
        np_[vn] = jnp.where(fluid_occ, new_vel[ax], planes[vn])
    np_["mask"] = mask_p
    # Warm start: keep the accumulated pressure for the next frame's loop
    # (cold start zeroes it, matching the reference's per-frame Press=0,
    # ref: model/sph/fluid.go:192).
    np_["press"] = c.press_plane if warm_start else zero

    # --- ballistic fallback + displacement trigger + conditional rebuild ---
    fb_vel = ps.fb_vel + g * dt
    fb_pos = ps.fb_pos + fb_vel * dt
    if bounds is not None:
        lo_a = jnp.asarray(lo, jnp.float32)
        hi_a = jnp.asarray(hi, jnp.float32)
        fhit = (fb_pos < lo_a) | (fb_pos > hi_a)
        fany = jnp.any(fhit, axis=-1, keepdims=True)
        fb_pos = jnp.clip(fb_pos, lo_a, hi_a)
        fb_vel = jnp.where(fhit, -restitution * fb_vel, fb_vel)
        fb_vel = jnp.where(fany & ~fhit, (1.0 - friction) * fb_vel, fb_vel)

    disp = jnp.maximum(jnp.maximum(jnp.abs(np_["x"] - ps.ref_x),
                                   jnp.abs(np_["y"] - ps.ref_y)),
                       jnp.abs(np_["z"] - ps.ref_z))
    max_disp = jnp.max(jnp.where(fluid_occ, disp, 0.0))
    need = max_disp >= jnp.float32(skin * params.h)
    n_fluid = ps.fb_pos.shape[0]

    def do_rebuild(op):
        np_p, fbp, fbv = op
        out = gather_planes([np_p["x"], np_p["y"], np_p["z"],
                             np_p["vx"], np_p["vy"], np_p["vz"],
                             np_p["press"]],
                            ps.flat[:n_fluid])
        valid_f = ps.valid[:n_fluid]
        pos_f = jnp.where(valid_f[:, None], out[:, 0:3], fbp)
        vel_f = jnp.where(valid_f[:, None], out[:, 3:6], fbv)
        press_f = jnp.where(valid_f, out[:, 6], 0.0)
        if ps.boundary_pos is not None:
            nb = ps.boundary_pos.shape[0]
            pos = jnp.concatenate([pos_f, ps.boundary_pos], axis=0)
            vel = jnp.concatenate([vel_f, jnp.zeros_like(ps.boundary_pos)],
                                  axis=0)
            press = jnp.concatenate([press_f, jnp.zeros((nb,), jnp.float32)])
        else:
            pos, vel, press = pos_f, vel_f, press_f
        planes2, bnd2, flat2, valid2, ovf2 = _bin_and_build(
            pos, vel, n_fluid, spec, press=press)
        return (planes2, bnd2, planes2["x"], planes2["y"], planes2["z"],
                flat2, valid2, pos_f, vel_f,
                jnp.maximum(ps.overflow, ovf2.astype(jnp.int32)),
                ps.rebuilds + 1)

    def keep(op):
        np_p, fbp, fbv = op
        return (np_p, ps.bnd, ps.ref_x, ps.ref_y, ps.ref_z,
                ps.flat, ps.valid, fbp, fbv, ps.overflow, ps.rebuilds)

    (planes3, bnd3, rx, ry, rz, flat3, valid3, fbp3, fbv3, ovf3,
     rb3) = jax.lax.cond(need, do_rebuild, keep, (np_, fb_pos, fb_vel))

    new_ps = DensePlaneState(
        planes=planes3, bnd=bnd3, ref_x=rx, ref_y=ry, ref_z=rz,
        flat=flat3, valid=valid3, fb_pos=fbp3, fb_vel=fbv3,
        boundary_pos=ps.boundary_pos, overflow=ovf3, rebuilds=rb3,
        age_total=ps.age_total + 1)
    return new_ps, c.it
