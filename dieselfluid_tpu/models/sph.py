"""The SPH system facade: configuration -> ready-to-run simulation.

ref: model/sph/fluid.go SPH struct + Init():23-88 — owns the field, particle
state, solver policy, NN-cache schedule, viscosity and the PCISPH delta. Here
it binds a SimConfig to params, initial state, a neighbor provider and a
jitted step function; everything stateful is explicit and functional
underneath (the facade only holds the current FluidState + step counter).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from dieselfluid_tpu.config import CACHE_L, FluidParams, SimConfig
from dieselfluid_tpu.models.particles import FluidState, dam_break_state, init_lattice_state
from dieselfluid_tpu.neighbors.bruteforce import brute_force_neighborhood
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.neighbors.cellgrid import CellGridSpec, cell_grid_neighborhood
from dieselfluid_tpu.solvers.integrate import StepDiagnostics
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta, pcisph_step
from dieselfluid_tpu.solvers.wcsph import wcsph_step


def build_step_fn(config: SimConfig, params: FluidParams, delta: float = 0.0,
                  collider=None) -> Callable:
    """step_fn(state) -> (state, diag) for a config/params binding.

    Factored out of Simulation.create so recovery paths (utils.guard) and
    parameter updates can rebind the jitted step to new params.
    """
    if config.neighbors == "dense":
        # Dense cell-plane pipeline (the production path)
        from dieselfluid_tpu.ops.cellops import DenseCellSpec
        from dieselfluid_tpu.solvers.dense_step import (
            dense_pcisph_step, dense_wcsph_step)

        dspec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                         capacity=config.cell_capacity)
        if config.solver == "pcisph":
            return lambda s: dense_pcisph_step(s, params, dspec, delta,
                                               collider=collider,
                                               warm_start=config.warm_start)
        return lambda s: dense_wcsph_step(s, params, dspec, collider=collider)

    if config.neighbors == "cellgrid":
        spec = CellGridSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                       capacity=config.cell_capacity)
        nfn = lambda pos: cell_grid_neighborhood(
            pos, pos, params.h, config.max_neighbors, spec)
    else:
        nfn = lambda pos: brute_force_neighborhood(
            pos, pos, params.h, config.max_neighbors)
    if config.solver == "pcisph":
        return lambda s: pcisph_step(s, params, delta, neighbor_fn=nfn,
                                     collider=collider,
                                     warm_start=config.warm_start)
    return lambda s: wcsph_step(s, params, neighbor_fn=nfn, collider=collider)


@dataclasses.dataclass
class Simulation:
    """A configured simulation: state + jitted step + bookkeeping."""

    config: SimConfig
    params: FluidParams
    state: FluidState
    step_fn: Callable[[FluidState], Tuple[FluidState, StepDiagnostics]]
    delta: float = 0.0
    step_count: int = 0
    cache_life: float = CACHE_L
    dx: float = 0.0

    @staticmethod
    def create(config: SimConfig, extent: float = 0.5,
               scene: str = "dam_break", collider=None,
               boundary_density: float = 1.0) -> "Simulation":
        """Build params/state/step from config (ref: sph.Init analog).

        `collider` (geometry.mesh.Mesh) mirrors sph.Init's colliders argument
        (ref: model/sph/fluid.go:41) — but actually wired: its boundary
        particles enter the solve as frozen fluid sources and its triangles
        run narrow-phase collision response each frame (the reference
        comments this out at fluid.go:70).
        """
        n3 = config.n3
        dx = (2.0 / n3) * extent
        params = FluidParams.for_spacing(dx)
        if scene == "dam_break":
            state = dam_break_state(n3, params, extent=extent)
        else:
            state = init_lattice_state(n3, params)
        # Both built-in scenes start on a cubic lattice of spacing dx, so
        # the O(1) analytic template gives the exact equilibrium d0. The
        # O(N^2) brute-force probe is a per-config fallback for arbitrary
        # initial states — at n3=50 its (N, N) distance matrix is 58 GB and
        # OOMs the chip (found driving the CLI dense path at 125k).
        params = lattice_rest_density(dx, params)
        if collider is not None:
            state = state._replace(
                boundary_pos=collider.generate_boundary_particles(
                    boundary_density))

        delta = 0.0
        if config.solver == "pcisph":
            delta = compute_pci_delta(params, dx)

        step_fn = build_step_fn(config, params, delta, collider)
        return Simulation(config=config, params=params, state=state,
                          step_fn=step_fn, delta=delta, dx=dx)

    # ------------------------------------------------------------- stepping
    def step(self, n: int = 1) -> StepDiagnostics:
        """Advance n frames (ref: the solver Run loop body)."""
        diag = None
        for _ in range(n):
            self.state, diag = self.step_fn(self.state)
            self.step_count += 1
        return diag

    def rollout(self, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """scan-compiled n-frame rollout; returns (positions (n,N,3), max_vels)."""
        def body(s, _):
            s, d = self.step_fn(s)
            return s, (s.pos, d.max_vel)

        final, (traj, vmax) = jax.lax.scan(body, self.state, None, length=n)
        self.state = final
        self.step_count += n
        return traj, vmax

    # ---------------------------------------------------------- ref surface
    def n(self) -> int:
        """Live particle count. ref: fluid.go N()."""
        return self.state.n

    def cfl(self) -> float:
        """Fixed timestep policy. ref: fluid.go CFL():111-114."""
        return self.params.dt

    def max_v(self) -> float:
        return float(jnp.max(jnp.linalg.norm(self.state.vel, axis=-1)))

    def viscosity(self) -> float:
        return self.params.mu

    def set_viscosity(self, mu: float):
        """ref: fluid.go SetViscosity — rebind the step to updated params."""
        self.params = self.params.replace(mu=mu)
        self.step_fn = build_step_fn(self.config, self.params, self.delta)

    def cache_incr(self) -> float:
        """NN cache-extinction schedule (ref: fluid.go CacheIncr:208-215).

        Parity API: our neighbor structures are rebuilt inside every jitted
        step (cheap sorted cell grid), so this only reproduces the decay
        bookkeeping the reference exposes.
        """
        self.cache_life *= self.cache_life
        if self.cache_life < 0.1:
            self.cache_life = CACHE_L
        return self.cache_life
