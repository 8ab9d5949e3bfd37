"""Particle state as an immutable SoA pytree.

The array-program replacement for the reference's mutable SoA ParticleArray
(ref: model/particle_array.go:5-136): positions/velocities/forces/densities/
pressures live as separate jnp arrays so every solver pass is a fused,
bandwidth-friendly array program. Boundary particles are carried as a separate
positions-only array (the reference appends them to the positions slice and
returns zeroed dynamics for them, ref: model/particle_array.go:98-123).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.geometry.grid import Grid, kern_grid


class FluidState(NamedTuple):
    """SoA fluid state. All arrays float32; pos/vel/force are (N,3), scalars (N,)."""

    pos: jnp.ndarray
    vel: jnp.ndarray
    force: jnp.ndarray
    density: jnp.ndarray
    pressure: jnp.ndarray
    boundary_pos: Optional[jnp.ndarray] = None  # (M,3) static boundary particles

    @property
    def n(self) -> int:
        """Live particle count (ref: ParticleArray.N)."""
        return self.pos.shape[0]

    @property
    def total(self) -> int:
        """Live + boundary count (ref: ParticleArray.Total)."""
        m = 0 if self.boundary_pos is None else self.boundary_pos.shape[0]
        return self.n + m

    def all_positions(self) -> jnp.ndarray:
        """Positions of live then boundary particles, as one (total,3) array."""
        if self.boundary_pos is None:
            return self.pos
        return jnp.concatenate([self.pos, self.boundary_pos], axis=0)


def zero_state(n: int, boundary_pos: Optional[jnp.ndarray] = None) -> FluidState:
    return FluidState(
        pos=jnp.zeros((n, 3), jnp.float32),
        vel=jnp.zeros((n, 3), jnp.float32),
        force=jnp.zeros((n, 3), jnp.float32),
        density=jnp.zeros((n,), jnp.float32),
        pressure=jnp.zeros((n,), jnp.float32),
        boundary_pos=boundary_pos,
    )


def init_lattice_state(
    n3: int,
    params: FluidParams,
    origin=(0.0, 0.0, 0.0),
    grid: Optional[Grid] = None,
    boundary_pos: Optional[jnp.ndarray] = None,
) -> FluidState:
    """Build the n3^3 lattice start state the reference builds in sph.Init.

    ref: model/sph/fluid.go:41-76 — particles on a kernel-spaced grid over
    [-1,1]^3, zero velocity, gravity pre-loaded into the force accumulator
    (Update resets force to gravity*mass each step, ref: fluid.go:192).
    """
    g = grid if grid is not None else kern_grid(n3, origin)
    pos = g.positions()
    n = pos.shape[0]
    gravity_force = jnp.broadcast_to(
        jnp.asarray(params.gravity, jnp.float32) * params.mass, (n, 3)
    )
    return FluidState(
        pos=pos,
        vel=jnp.zeros((n, 3), jnp.float32),
        force=gravity_force,
        density=jnp.zeros((n,), jnp.float32),
        pressure=jnp.zeros((n,), jnp.float32),
        boundary_pos=boundary_pos,
    )


def dam_break_state(n3: int, params: FluidParams, extent: float = 0.5) -> FluidState:
    """A dam-break column: lattice compressed into one corner of the unit box.

    BASELINE config 1 ("WCSPH dam-break, 8k particles"). The lattice spacing is
    scaled by `extent` so the fluid occupies a sub-box and collapses under
    gravity against the domain walls.
    """
    base = init_lattice_state(n3, params)
    lo = jnp.asarray([-1.0, -1.0, -1.0], jnp.float32)
    pos = lo + (base.pos - lo) * extent
    return base._replace(pos=pos)


def to_aos(state: FluidState) -> jnp.ndarray:
    """SoA -> AoS (N, 11) rows of [pos vel force density pressure].

    Capability of the reference's AoS views — model/particle.go Particle and
    the secondary ParticleStructField impl (ref: model/particle_struct_field.go:9,
    model/particle_array.go:72-96 Get) — as one layout transform instead of a
    per-index marshal loop.
    """
    return jnp.concatenate(
        [state.pos, state.vel, state.force,
         state.density[:, None], state.pressure[:, None]], axis=-1)


def from_aos(aos: jnp.ndarray,
             boundary_pos: Optional[jnp.ndarray] = None) -> FluidState:
    """AoS (N, 11) -> SoA FluidState (ref: model/particle_array.go:98-121 Set)."""
    return FluidState(
        pos=aos[:, 0:3], vel=aos[:, 3:6], force=aos[:, 6:9],
        density=aos[:, 9], pressure=aos[:, 10], boundary_pos=boundary_pos)


def particle(state: FluidState, i) -> jnp.ndarray:
    """One AoS row by global index over [fluid | boundary].

    Boundary indices (i >= n) return their position with zeroed dynamics,
    matching ref: model/particle_array.go:98-105.
    """
    n = state.n
    fluid_row = to_aos(state)[jnp.minimum(i, n - 1)]
    if state.boundary_pos is None:
        return fluid_row
    b = state.boundary_pos[jnp.clip(i - n, 0, state.boundary_pos.shape[0] - 1)]
    boundary_row = jnp.concatenate([b, jnp.zeros((8,), jnp.float32)])
    return jnp.where(i < n, fluid_row, boundary_row)


def tree_stack(states):
    """Stack a list of states along a leading time axis (animation export)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)
