"""Time integration and boundary handling shared by all solvers."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState


class StepDiagnostics(NamedTuple):
    """Per-step global reductions (psum'd under sharding).

    The reference tracks these as mutable maxima across all history
    (ref: model/sph/fluid.go:184-191); we report per-step values.
    `overflow` counts particles dropped from the neighbor structure this step
    (dense-cell capacity or cell-grid candidate overflow) — nonzero means the
    step silently under-resolved interactions; callers should resize capacity.
    """

    max_vel: jnp.ndarray
    max_force: jnp.ndarray
    overflow: jnp.ndarray = 0  # jnp.int32 scalar when set by a solver
    iters: jnp.ndarray = 0     # PCISPH correction iterations taken this step


def semi_implicit_euler(
    state: FluidState, params: FluidParams, mass=None
) -> Tuple[FluidState, StepDiagnostics]:
    """Symplectic Euler update + force/pressure reset.

    ref: model/sph/fluid.go Update:175-197 — a = F/m; v += a dt; x += v dt;
    then pressure := 0 and force := gravity * mass for the next frame.

    `mass` optionally overrides params.mass with a traced Materials scalar so
    d(step)/d(mass) is complete when the force path traces mass too.
    """
    m = params.mass if mass is None else mass
    a = state.force / m
    vel = state.vel + a * params.dt
    pos = state.pos + vel * params.dt
    diag = StepDiagnostics(
        max_vel=jnp.max(jnp.linalg.norm(vel, axis=-1)),
        max_force=jnp.max(jnp.linalg.norm(state.force, axis=-1)),
    )
    gravity_force = jnp.asarray(params.gravity, jnp.float32) * m
    new = state._replace(
        pos=pos,
        vel=vel,
        force=jnp.broadcast_to(gravity_force, pos.shape).astype(pos.dtype),
        pressure=jnp.zeros_like(state.pressure),
    )
    return new, diag


def box_collide(
    state: FluidState,
    lo=(-1.0, -1.0, -1.0),
    hi=(1.0, 1.0, 1.0),
    restitution: float = 0.3,
    friction: float = 0.1,
) -> FluidState:
    """Axis-aligned box container: clamp positions, reflect + damp velocities.

    The reference declares mesh colliders but never wires them in
    (ref: model/sph/fluid.go:70 commented out; geom/interfaces.go mismatch
    documented in SURVEY.md) — a box container is required for a dam break to
    be bounded, so this is a deliberate capability addition. `friction` damps
    the tangential velocity of wall-contact particles; without it, settled
    particles ping-pong between wall clamp and pressure kicks and slowly gain
    energy (observed in verification).
    """
    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    below = state.pos < lo
    above = state.pos > hi
    hit = below | above
    any_hit = jnp.any(hit, axis=-1, keepdims=True)
    pos = jnp.clip(state.pos, lo, hi)
    vel = jnp.where(hit, -restitution * state.vel, state.vel)
    vel = jnp.where(any_hit & ~hit, (1.0 - friction) * vel, vel)
    return state._replace(pos=pos, vel=vel)


def cfl_dt(params: FluidParams, max_vel: Optional[jnp.ndarray] = None):
    """Timestep policy. The reference pins dt=0.01 (ref: model/sph/fluid.go:111-114);
    when max_vel is given we additionally bound dt by the standard CFL condition
    dt <= 0.4 h / max|v| as an improvement (still returning a traced scalar)."""
    if max_vel is None:
        return jnp.float32(params.dt)
    return jnp.minimum(jnp.float32(params.dt), 0.4 * params.h / jnp.maximum(max_vel, 1e-6))
