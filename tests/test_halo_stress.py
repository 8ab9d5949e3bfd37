"""Multi-chip correctness UNDER LOAD (round-3 verdict, next-step #6).

64k particles over the full 8-device virtual CPU mesh, 50+ steps of
distributed PCISPH with boundary stores, cross-face migration, and
capacity churn — asserting particle conservation, zero drops, bounded
per-slab imbalance, and physical health the whole way.

This stress runs the XLA halo pipeline (parallel/halo.py): it shares the
SlabState store, migration buffers, boundary replication, and collective
protocol with the dense twin (parallel/dense_halo.py reuses
halo._migrate and SlabState verbatim) but is far cheaper on the CPU mesh:
the dense twin sweeps whole cell planes per device, and 64k x 50 steps of
it is too slow for the test tier. Dense-halo parity itself is covered at
feasible scale in tests/test_dense_halo.py; THIS test is where the shared
migration/capacity machinery meets realistic occupancy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.geometry.mesh import box
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
from dieselfluid_tpu.parallel.halo import SlabSpec, collect, distribute
from dieselfluid_tpu.parallel.sharding import particle_mesh
from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

N_DEV = 8


@pytest.mark.slow
def test_64k_boundary_dam_break_under_churn():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    n3, extent = 40, 0.5                     # 64,000 fluid particles
    dx = (2.0 / n3) * extent
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    state = dam_break_state(n3, params, extent=extent)
    # Sideways slam: drives a cross-slab surge so particles migrate over
    # x-faces while the dam collapses (capacity churn on the face slabs).
    state = state._replace(
        vel=state.vel + jnp.asarray([1.5, -1.0, 0.0], jnp.float32))
    container = box(1.9, 1.9, 1.9)
    state = state._replace(
        boundary_pos=container.generate_boundary_particles(dx / params.h))
    delta = compute_pci_delta(params, dx)

    n = state.n
    # Slab capacity ~1.9x the uniform share: the surge piles particles into
    # the +x slabs; the test asserts none are dropped at this headroom.
    spec = SlabSpec(n_dev=N_DEV, capacity=2 * 8192, halo_capacity=4096,
                    migrate_capacity=2048, h=params.h)
    mesh = particle_mesh(N_DEV)
    slabs = distribute(state, spec)
    assert float(slabs.dropped) == 0.0

    from dieselfluid_tpu.parallel.halo import make_halo_pcisph_step

    step = make_halo_pcisph_step(mesh, spec, params, delta, k=56,
                                 cell_capacity=24, boundary=True,
                                 warm_start=True)
    steps = 50
    per_slab_hist, vel_hist = [], []
    for i in range(steps):
        slabs, max_vel, n_live, per_slab = step(slabs)
        jax.block_until_ready(slabs.pos)      # CPU-mesh collective pitfall
        # Conservation + integrity EVERY step: a particle lost to a full
        # migration buffer or slab store shows up immediately.
        assert int(n_live) == n, f"step {i}: lost particles {int(n_live)}/{n}"
        assert float(slabs.dropped) == 0.0, f"step {i}: drops"
        # 1e3+ means Tait/CFL blowup; the impact transient peaks ~25-30.
        assert np.isfinite(float(max_vel)) and float(max_vel) < 100.0, (
            f"step {i}: max|v|={float(max_vel)} (blowup)")
        per_slab_hist.append(np.asarray(per_slab))
        vel_hist.append(float(max_vel))

    per_slab = np.stack(per_slab_hist)        # (steps, n_dev)
    assert per_slab.sum(axis=1).min() == n
    # Migration actually happened: slab populations changed over the run.
    moved = np.abs(per_slab[-1] - per_slab[0]).sum()
    assert moved > 0.01 * n, f"no churn: {moved} particles moved"
    # Load never presses the per-slab capacity (would mean silent drops
    # next step), and the collapse SPREADS the load: final imbalance is
    # below the initial dam geometry's 2.0 (4 of 8 slabs hold everything).
    assert per_slab.max() < spec.capacity, "slab store at capacity"
    imb = per_slab / np.maximum(per_slab.mean(axis=1, keepdims=True), 1.0)
    assert imb[-1].max() < imb[0].max() - 0.05, (
        f"dam never spread: imbalance {imb[0].max():.2f} -> {imb[-1].max():.2f}")

    # The impact transient decays: the run ends slower than its peak.
    assert max(vel_hist[-10:]) < max(vel_hist), "velocity still growing"

    pos, vel = collect(slabs)
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    assert pos.shape[0] == n
    # The dam broke: spread along +x, fell in y, inside the container.
    assert pos[:, 1].mean() < state.pos[:, 1].mean()
    assert np.abs(pos).max() <= 1.0        # wall clamp is exactly the box
