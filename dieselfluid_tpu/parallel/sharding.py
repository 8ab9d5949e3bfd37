"""Device-mesh sharding of the particle system.

The reference is single-process, single-device with explicit host<->device
buffer copies (ref: compute/gpu/gpu.go:332-389 — its entire "distributed
backend" per SURVEY.md §2.7/§2.11). The replacement here is jax.sharding:
particles are sharded over an ``sp`` (spatial/particle) mesh axis, XLA's GSPMD
inserts the collectives, and global reductions (max velocity, density error —
ref computes these as global loops, model/sph/fluid.go:186-191) become psums.

Round-1 strategy: shard the *query* particle axis and let GSPMD all-gather the
source positions for the pairwise/gather phase (data-parallel over particles).
The sorted-cell-grid + ppermute halo exchange (true domain decomposition, the
context-parallel analog in SURVEY.md §5) lands on top of the cell-grid
neighbor provider.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.materials import Materials
from dieselfluid_tpu.models.particles import FluidState
from dieselfluid_tpu.solvers.wcsph import compute_forces, default_neighbor_fn
from dieselfluid_tpu.solvers.integrate import box_collide, semi_implicit_euler


def particle_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1D mesh over the particle axis, named ``sp`` (spatial parallel)."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return jax.make_mesh((len(devices),), ("sp",), devices=devices)


def state_sharding(mesh: Mesh) -> FluidState:
    """A FluidState of NamedShardings: particle axis sharded over ``sp``."""
    row = NamedSharding(mesh, P("sp"))
    return FluidState(
        pos=NamedSharding(mesh, P("sp", None)),
        vel=NamedSharding(mesh, P("sp", None)),
        force=NamedSharding(mesh, P("sp", None)),
        density=row,
        pressure=row,
        boundary_pos=None,
    )


def shard_state(state: FluidState, mesh: Mesh) -> FluidState:
    """Place a state on the mesh (particle axis must divide the device count)."""
    sh = state_sharding(mesh)
    put = lambda x, s: x if x is None else jax.device_put(x, s)
    return FluidState(
        pos=put(state.pos, sh.pos),
        vel=put(state.vel, sh.vel),
        force=put(state.force, sh.force),
        density=put(state.density, sh.density),
        pressure=put(state.pressure, sh.pressure),
        boundary_pos=state.boundary_pos,
    )


def sharded_train_step(
    mesh: Mesh,
    params: FluidParams,
    n_sim_steps: int = 2,
    lr: float = 1e-3,
    neighbor_k: int = 64,
):
    """Build a jitted, mesh-sharded training step: rollout -> loss -> grads -> SGD.

    The "training" of a differentiable simulator: a loss on the rolled-out
    state is differentiated to initial velocities and material parameters
    (viscosity/stiffness), psum-reduced across the sp axis by the shard_map
    transpose, and applied as an SGD update. This is the multichip path the
    driver dry-runs.
    """
    from dieselfluid_tpu.parallel.spmd import make_spmd_rollout

    spmd_rollout = make_spmd_rollout(mesh, params, n_sim_steps, k=neighbor_k)

    def loss_fn(vel0: jnp.ndarray, materials: Materials, state: FluidState):
        state = state._replace(vel=vel0)
        final, _ = spmd_rollout(state, materials)
        # Match a target: fluid should settle toward the box floor.
        target_y = -0.9
        return jnp.mean((final.pos[:, 1] - target_y) ** 2) + 1e-4 * jnp.mean(
            final.vel ** 2
        )

    def train_step(vel0, materials, state):
        loss, (g_vel, g_mat) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            vel0, materials, state
        )
        vel0 = vel0 - lr * g_vel
        materials = jax.tree.map(lambda m, g: m - lr * g, materials, g_mat)
        return loss, vel0, materials

    sh = state_sharding(mesh)
    rep = NamedSharding(mesh, P())
    mat_sh = jax.tree.map(lambda _: rep, Materials.from_params(params))
    return jax.jit(
        train_step,
        in_shardings=(sh.vel, mat_sh, sh),
        out_shardings=(rep, sh.vel, mat_sh),
    )
