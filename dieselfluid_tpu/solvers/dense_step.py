"""WCSPH/PCISPH steps on the dense cell pipeline.

The production path: scatter particles into dense cell planes
(ops/cellops.py), run the density/force stencil sweeps (ops/pallas_sph.py),
gather per-particle results, integrate with the shared integrator. Forward
semantics match the XLA gather path (field.density_with_self + pressure_force
+ laplacian_force) — tested against it — while avoiding its sort/top_k/gather
costs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState
from dieselfluid_tpu.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_plane,
    gather_planes,
)
from dieselfluid_tpu.ops.pallas_sph import (
    density_planes,
    force_planes,
    pressure_force_planes,
    pressure_force_pq_planes,
    viscosity_force_planes,
)
from dieselfluid_tpu.ops.smoothing import KernelCoeffs, tait_eos
from dieselfluid_tpu.solvers.integrate import StepDiagnostics, box_collide, semi_implicit_euler


def _material_scalars(params: FluidParams, materials):
    """(mass, mu, d0, gamma, w) — traced Materials overrides when given
    (mirrors solvers.wcsph.compute_forces), static FluidParams otherwise."""
    if materials is None:
        return (params.mass, params.mu, params.d0, params.tait_gamma,
                params.tait_w)
    return (materials.mass, materials.mu, materials.d0,
            materials.tait_gamma, materials.tait_w)


def _boundary_extended(state: FluidState):
    """(pos, vel) with boundary particles appended as frozen fluid sources
    (see solvers.wcsph.extend_with_boundary for the semantics + ref cites)."""
    if state.boundary_pos is None:
        return state.pos, state.vel
    b = state.boundary_pos
    pos = jnp.concatenate([state.pos, b], axis=0)
    vel = jnp.concatenate([state.vel, jnp.zeros_like(b)], axis=0)
    return pos, vel


def dense_density_forces(state: FluidState, params: FluidParams,
                         spec: DenseCellSpec, materials=None):
    """(rho, pressure, force, overflow) for the current positions, fluid
    particles only ([:n]); boundary particles (state.boundary_pos) join the
    dense planes as frozen fluid sources.

    `materials` (models.materials.Materials) optionally supplies traced
    mass/mu/d0/gamma/w: the geometry scalars stay baked in the kernels, but
    every material scale is applied outside the sweeps (factored kernels),
    so Materials gradients flow on this production path too. With materials
    the force runs as two factored sweeps (pressure + viscosity) instead of
    the fused one.
    """
    mass, mu, d0, gamma, w = _material_scalars(params, materials)
    n = state.pos.shape[0]
    pos, vel = _boundary_extended(state)

    flat, valid, overflow = dense_indices(pos, spec)
    planes = build_planes(
        {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
         "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2]},
        flat, valid, spec,
    )
    k = KernelCoeffs.build(params.h)
    rho_plane = density_planes(planes, spec, k, mass)
    press_plane = jnp.where(
        planes["mask"] > 0,
        tait_eos(rho_plane, d0, params.p0, gamma, w),
        0.0,
    )
    if materials is None:
        fx_p, fy_p, fz_p = force_planes(planes, rho_plane, press_plane, spec,
                                        k, params.mass, float(params.mu))
    else:
        px, py, pz = pressure_force_planes(planes, rho_plane, press_plane,
                                           spec, k, mass)
        vx, vy, vz = viscosity_force_planes(planes, rho_plane, spec, k,
                                            mass, mu)
        fx_p, fy_p, fz_p = px + vx, py + vy, pz + vz

    flat_f, valid_f = flat[:n], valid[:n]
    out = gather_planes([rho_plane, press_plane, fx_p, fy_p, fz_p], flat_f)
    rho, pressure, force = out[:, 0], out[:, 1], out[:, 2:5]
    # Overflowed particles fall back to zero interaction (gravity only);
    # overflow is returned so callers can size capacity.
    rho = jnp.where(valid_f, rho, d0)
    pressure = jnp.where(valid_f, pressure, 0.0)
    force = jnp.where(valid_f[:, None], force, 0.0)
    return rho, pressure, force, overflow


@partial(jax.jit, static_argnames=("params", "spec", "bounds"))
def dense_wcsph_step(
    state: FluidState,
    params: FluidParams,
    spec: DenseCellSpec,
    bounds: Optional[Tuple] = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    collider=None,
    materials=None,
) -> Tuple[FluidState, StepDiagnostics]:
    """One WCSPH frame on the Pallas pipeline. diag.overflow reports dropped
    particles (cell-capacity) — nonzero means resize the spec's capacity.
    `materials` enables traced material-parameter gradients (see
    dense_density_forces)."""
    mass = params.mass if materials is None else materials.mass
    rho, pressure, f, overflow = dense_density_forces(state, params, spec,
                                                      materials)
    gravity = jnp.asarray(params.gravity, jnp.float32) * mass
    state = state._replace(density=rho, pressure=pressure, force=gravity + f)
    state, diag = semi_implicit_euler(state, params, mass=mass)
    diag = diag._replace(overflow=overflow)
    if bounds is not None:
        state = box_collide(state, *bounds)
    if collider is not None:
        from dieselfluid_tpu.geometry.mesh import mesh_collide

        state = mesh_collide(state, collider, params.dt, 0.5 * params.h)
    return state, diag


@partial(jax.jit, static_argnames=("params", "spec", "delta", "bounds",
                                   "unroll_for_grad", "warm_start",
                                   "unroll_iters"))
def dense_pcisph_step(
    state: FluidState,
    params: FluidParams,
    spec: DenseCellSpec,
    delta: float,
    bounds: Optional[Tuple] = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    collider=None,
    materials=None,
    unroll_for_grad: bool = False,
    warm_start: bool = False,
    unroll_iters: Optional[int] = None,
) -> Tuple[FluidState, StepDiagnostics]:
    """One PCISPH frame on the Pallas pipeline.

    The cell binning is frozen for the frame (computed at the pre-step
    positions) while predicted positions update the plane *values* each
    correction iteration — the dense-layout analog of the reference's frozen
    LSH sampler within a frame (ref: solver/pcisph/pcisph_darwin.go keeps its
    table until the next SAMPLER_UPDATE).

    `materials` supplies traced mass/mu/d0 (material-parameter gradients on
    the production path — BASELINE config 4). `unroll_for_grad=True` replaces
    the correction while_loop with a fixed pci_max_iters scan so the step is
    reverse-differentiable (lax.while_loop is not; mirror of
    solvers.pcisph.pcisph_step_core). `warm_start=True` keeps the
    accumulated pressure in the returned state so the next frame's loop
    starts from it (see solvers.pcisph.pcisph_step).
    """
    from dieselfluid_tpu.solvers.pcisph import _Carry

    mass, mu, d0, _, _ = _material_scalars(params, materials)
    k = KernelCoeffs.build(params.h)
    n = state.pos.shape[0]
    pos0, vel0 = _boundary_extended(state)
    flat, valid, overflow = dense_indices(pos0, spec)
    flat_f, valid_f = flat[:n], valid[:n]

    planes = build_planes(
        {"x": pos0[:, 0], "y": pos0[:, 1], "z": pos0[:, 2],
         "vx": vel0[:, 0], "vy": vel0[:, 1], "vz": vel0[:, 2]},
        flat, valid, spec,
    )
    rho_plane = density_planes(planes, spec, k, mass)
    # Every gather below is sanitized with valid_f: an overflowed particle's
    # clamped `flat` aliases a VALID slot (cellops.dense_indices), so an
    # unmasked gather hands it a *neighbor's* density/pressure/force — wrong
    # physics, not degraded physics. The fallback
    # here matches dense_density_forces: rho=d0, zero interaction force.
    rho = jnp.where(valid_f, gather_plane(rho_plane, flat_f), d0)
    # External forces: gravity + viscosity at the unpredicted state, via the
    # dedicated factored viscosity sweep (cheaper than the old fused kernel
    # against a zero pressure plane, and mu/mass may be traced).
    vx_p, vy_p, vz_p = viscosity_force_planes(planes, rho_plane, spec, k,
                                              mass, mu)
    visc = jnp.where(valid_f[:, None],
                     gather_planes([vx_p, vy_p, vz_p], flat_f), 0.0)
    gravity = jnp.asarray(params.gravity, jnp.float32) * mass
    ext_force = gravity + visc

    def to_plane(values_f, boundary_value=None):
        """Per-fluid values -> plane (scatter over the frozen binning);
        boundary slots get boundary_value."""
        out = jnp.zeros(spec.rows * spec.row_len, jnp.float32).at[
            jnp.where(valid_f, flat_f, 0)
        ].add(jnp.where(valid_f, values_f, 0.0))
        if state.boundary_pos is not None and boundary_value is not None:
            flat_b, valid_b = flat[n:], valid[n:]
            out = out.at[jnp.where(valid_b, flat_b, 0)].add(
                jnp.where(valid_b, boundary_value, 0.0))
        return out.reshape(spec.plane_shape)

    def body(c):
        accel = (ext_force + c.f_p) / mass
        vel_star = state.vel + accel * params.dt
        pos_star = state.pos + vel_star * params.dt
        if state.boundary_pos is not None:
            pos_ext = jnp.concatenate([pos_star, state.boundary_pos], axis=0)
        else:
            pos_ext = pos_star
        # Density at the predicted positions needs positions only (3-channel
        # scatter; the binning — and so the mask — is frozen for the frame);
        # the correction force runs the pressure-only kernel, so neither
        # pass touches velocity planes.
        p_star = build_planes(
            {"x": pos_ext[:, 0], "y": pos_ext[:, 1], "z": pos_ext[:, 2]},
            flat, valid, spec, mask=planes["mask"])
        rho_star_plane = density_planes(p_star, spec, k, mass)
        rho_star = jnp.where(valid_f, gather_plane(rho_star_plane, flat_f),
                             d0)
        err = rho_star - d0
        pressure = jnp.maximum(c.pressure + delta * err, 0.0)
        # Boundary slots: zero pressure (they only receive the p_i-side of
        # the symmetric term), rest density for the rho_j divisor.
        press_plane = to_plane(pressure)
        rho_for_force = jnp.maximum(rho_star, 0.5 * d0)
        rff_plane = to_plane(rho_for_force, boundary_value=d0)
        fx_p, fy_p, fz_p = pressure_force_planes(planes, rff_plane,
                                                 press_plane, spec, k, mass)
        f_p = jnp.where(valid_f[:, None],
                        gather_planes([fx_p, fy_p, fz_p], flat_f), 0.0)
        max_ratio = jnp.max(err) / d0
        return _Carry(c.it + 1, max_ratio, pressure, f_p)

    class _PlaneCarry(NamedTuple):
        it: jnp.ndarray
        err: jnp.ndarray
        press_plane: jnp.ndarray
        fpx: jnp.ndarray
        fpy: jnp.ndarray
        fpz: jnp.ndarray

    def plane_loop():
        """PLANE-RESIDENT correction loop (the production while_loop path).

        Every per-iteration quantity — predicted positions, pressures,
        correction forces, the density error — lives in plane form: the
        integration prediction and pressure update are ELEMENTWISE plane
        math, so an iteration runs exactly two sweeps (density at predicted
        positions + pressure force) and ZERO scatters/gathers. The old
        particle-resident body paid 5 scatters + 2 gathers per iteration
        shuttling values out of and back into
        the planes the sweeps want anyway. Per-particle state is touched
        once, after the loop exits."""
        mask_p = planes["mask"]
        occ = mask_p > 0
        # Boundary indicator plane (fluid slots 0, boundary slots 1) and
        # the fluid-slot predicate — boundary slots stay frozen, keep zero
        # pressure, and read rest density as the force divisor.
        bnd_p = to_plane(jnp.zeros((n,), jnp.float32), boundary_value=1.0)
        fluid_occ = occ & (bnd_p == 0)
        g = jnp.asarray(params.gravity, jnp.float32)
        extf = (vx_p + g[0] * mass, vy_p + g[1] * mass, vz_p + g[2] * mass)
        vels = (planes["vx"], planes["vy"], planes["vz"])
        poss = (planes["x"], planes["y"], planes["z"])

        def pbody(c: _PlaneCarry) -> _PlaneCarry:
            star = {}
            for ax, name in enumerate(("x", "y", "z")):
                accel = (extf[ax] + (c.fpx, c.fpy, c.fpz)[ax]) / mass
                xs = poss[ax] + (vels[ax] + accel * params.dt) * params.dt
                star[name] = jnp.where(fluid_occ, xs, poss[ax])
            star["mask"] = mask_p
            rho_star = density_planes(star, spec, k, mass)
            err = jnp.where(fluid_occ, rho_star - d0, 0.0)
            press = jnp.where(
                fluid_occ, jnp.maximum(c.press_plane + delta * err, 0.0),
                0.0)
            # Prefolded pq = press / rho_ff^2: boundary slots have zero
            # pressure so their pq is 0 regardless of divisor — the rff
            # plane collapses into this one elementwise expression.
            rff = jnp.maximum(rho_star, 0.5 * d0)
            pq = jnp.where(fluid_occ, press / (rff * rff), 0.0)
            fx, fy, fz = pressure_force_pq_planes(planes, pq, spec, k, mass)
            max_ratio = jnp.max(err) / d0
            return _PlaneCarry(c.it + 1, max_ratio, press, fx, fy, fz)

        zero = jnp.zeros(spec.plane_shape, jnp.float32)
        init = _PlaneCarry(it=jnp.int32(0), err=jnp.float32(jnp.inf),
                           press_plane=to_plane(state.pressure),
                           fpx=zero, fpy=zero, fpz=zero)
        cond = lambda c: (c.it < params.pci_max_iters) & (
            c.err > params.pci_max_density_error_ratio)
        c = jax.lax.while_loop(cond, pbody, init)
        # Back to particle-resident state, once. Overflowed particles keep
        # the ungated loop's fallback semantics: zero interaction force,
        # pressure = clamp(initial).
        pressure = jnp.where(valid_f, gather_plane(c.press_plane, flat_f),
                             jnp.maximum(state.pressure, 0.0))
        f_p = jnp.where(valid_f[:, None],
                        gather_planes([c.fpx, c.fpy, c.fpz], flat_f), 0.0)
        return _Carry(c.it, c.err, pressure, f_p)

    # Iteration zero accumulates onto state.pressure (cold-started by the
    # integrator's reset unless warm_start keeps it — see pcisph_step_core).
    init = _Carry(it=jnp.int32(0), err=jnp.float32(jnp.inf),
                  pressure=state.pressure,
                  f_p=jnp.zeros_like(state.force))
    if unroll_for_grad:
        # Rematerialize each correction iteration in the backward pass:
        # without this the reverse-mode scan holds every iteration's plane
        # set (~0.5 GB x pci_max_iters at 1M) in device memory for the
        # backward.
        ckpt_body = jax.checkpoint(body)

        def scan_body(c, _):
            return ckpt_body(c), None

        # unroll_iters: fixed reverse-differentiable iteration count.
        # Defaults to the pci_max_iters cap; callers that observed the
        # adaptive while_loop converging earlier (diag.iters) can match it
        # and pay only that many fwd+bwd sweeps.
        carry, _ = jax.lax.scan(scan_body, init, None,
                                length=unroll_iters or params.pci_max_iters)
    else:
        carry = plane_loop()

    state = state._replace(density=rho, pressure=carry.pressure,
                           force=ext_force + carry.f_p)
    state, diag = semi_implicit_euler(state, params, mass=mass)
    if warm_start:
        state = state._replace(pressure=carry.pressure)
    diag = diag._replace(overflow=overflow, iters=carry.it)
    if bounds is not None:
        state = box_collide(state, *bounds)
    if collider is not None:
        from dieselfluid_tpu.geometry.mesh import mesh_collide

        state = mesh_collide(state, collider, params.dt, 0.5 * params.h)
    return state, diag
