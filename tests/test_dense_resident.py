"""Plane-resident WCSPH (solvers.dense_resident) vs the per-step dense path.

skin=0.0 forces a rebuild every frame, which is semantically identical to
dense_wcsph_step (fresh binning at the swept positions each step) — parity
is tight. skin>0 freezes the binning between rebuilds; the deviation is
bounded by the missed-shell analysis in the module docstring and checked
loose here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.ops.cellops import DenseCellSpec
from dieselfluid_tpu.solvers.dense_resident import (
    dense_wcsph_resident_step,
    fluid_state_from_planes,
    plane_state_from_fluid,
)
from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step


@pytest.fixture(scope="module")
def setup():
    n3, extent = 8, 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    s = dam_break_state(n3, params, extent=extent)
    s = s._replace(vel=jax.random.normal(jax.random.PRNGKey(3),
                                         s.vel.shape) * 0.1)
    params = params.replace(d0=float(1.1 * params.d0))
    spec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                    capacity=16)
    return params, s, spec


def _run_resident(s, params, spec, steps, skin):
    ps = plane_state_from_fluid(s, spec)
    for _ in range(steps):
        ps = dense_wcsph_resident_step(ps, params, spec, skin=skin)
    return ps


def _run_per_step(s, params, spec, steps):
    for _ in range(steps):
        s, _ = dense_wcsph_step(s, params, spec)
    return s


class TestResidentParity:
    def test_skin_zero_matches_per_step(self, setup):
        params, s, spec = setup
        steps = 4
        ps = _run_resident(s, params, spec, steps, skin=0.0)
        ref = _run_per_step(s, params, spec, steps)
        out = fluid_state_from_planes(ps, s.n, params, spec)
        assert int(ps.rebuilds) == steps  # skin 0 rebuilds every frame
        np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                                   atol=1e-5)

    @pytest.mark.slow
    def test_skin_small_stays_close_and_amortizes(self, setup):
        """skin=0.05 amortizes rebuilds; the trajectory stays within a
        fraction of the particle spacing of the rebuild-every-step path.
        (The deviation is a physical approximation error amplified by this
        deliberately stiff fixture — the direct bound on what the skin
        argument guarantees is test_frozen_binning_density_error.)"""
        params, s, spec = setup
        steps = 6
        ps = _run_resident(s, params, spec, steps, skin=0.05)
        ref = _run_per_step(s, params, spec, steps)
        out = fluid_state_from_planes(ps, s.n, params, spec)
        dx_spacing = 0.125  # lattice spacing of the 8^3 fixture
        dev = float(jnp.max(jnp.abs(out.pos - ref.pos)))
        assert dev < 0.5 * dx_spacing, dev
        assert np.all(np.isfinite(np.asarray(out.pos)))
        # The whole point: fewer rebuilds than steps.
        assert int(ps.rebuilds) < steps
        assert int(ps.age_total) == steps

    def test_frozen_binning_density_error(self, setup):
        """The skin bound itself: after stepping with a frozen binning, the
        density computed through the STALE binning matches a fresh binning
        at the SAME positions to well under the PCISPH tolerance (missed
        pairs live in the outer kernel shell, weight O((2*skin)^3))."""
        params, s, spec = setup
        from dieselfluid_tpu.ops.cellops import (build_planes, dense_indices,
                                                 gather_plane)
        from dieselfluid_tpu.ops.smoothing import KernelCoeffs
        from dieselfluid_tpu.ops.pallas_sph import density_planes

        ps = _run_resident(s, params, spec, 6, skin=0.05)
        out = fluid_state_from_planes(ps, s.n, params, spec)
        k = KernelCoeffs.build(params.h)
        # Stale binning (the planes as the resident step left them).
        rho_stale = gather_plane(
            density_planes(ps.planes, spec, k, params.mass), ps.flat[:s.n])
        # Fresh binning at the same positions.
        flat, valid, _ = dense_indices(out.pos, spec)
        planes = build_planes(
            {"x": out.pos[:, 0], "y": out.pos[:, 1], "z": out.pos[:, 2],
             "vx": out.vel[:, 0], "vy": out.vel[:, 1],
             "vz": out.vel[:, 2]},
            flat, valid, spec)
        rho_fresh = gather_plane(
            density_planes(planes, spec, k, params.mass), flat)
        ok = np.asarray(ps.valid[:s.n]) & np.asarray(valid)
        rel = np.abs(np.asarray(rho_stale) - np.asarray(rho_fresh))[ok] / params.d0
        assert rel.max() < 2e-3, rel.max()

    def test_large_motion_triggers_rebuild(self, setup):
        params, s, spec = setup
        fast = s._replace(vel=jnp.full_like(s.vel, 2.0))
        ps = plane_state_from_fluid(fast, spec)
        ps = dense_wcsph_resident_step(ps, params, spec, skin=0.05)
        assert int(ps.rebuilds) == 1

    def test_overflow_fallback_ballistic(self, setup):
        params, s, spec = setup
        tight = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                         capacity=1)
        ps = plane_state_from_fluid(s, tight)
        assert int(ps.overflow) > 0
        n_inv = int(np.sum(~np.asarray(ps.valid[:s.n])))
        ps2 = dense_wcsph_resident_step(ps, params, tight, skin=1e9)
        out = fluid_state_from_planes(ps2, s.n, params, tight)
        # Overflowed particles follow the exact ballistic fallback update
        # (gravity only, matching dense_step's valid-mask semantics).
        inv = ~np.asarray(ps.valid[:s.n])
        assert n_inv > 0
        g = jnp.asarray(params.gravity, jnp.float32)
        v_exp = s.vel + g * params.dt
        p_exp = jnp.clip(s.pos + v_exp * params.dt, -1.0, 1.0)
        np.testing.assert_allclose(np.asarray(out.pos)[inv],
                                   np.asarray(p_exp)[inv], atol=1e-6)

    def test_boundary_slots_frozen(self, setup):
        params, s, spec = setup
        from dieselfluid_tpu.geometry.mesh import box

        b = box(1.8, 1.8, 1.8).generate_boundary_particles(1.0)
        sb = s._replace(boundary_pos=b)
        ps = plane_state_from_fluid(sb, spec)
        for _ in range(2):
            ps = dense_wcsph_resident_step(ps, params, spec, skin=1e9)
        # Boundary particle slots never move: gather them via the tail of
        # the slot map and compare against the static boundary positions.
        nb = b.shape[0]
        from dieselfluid_tpu.ops.cellops import gather_planes

        got = gather_planes([ps.planes["x"], ps.planes["y"], ps.planes["z"]],
                            ps.flat[s.n:])
        vb = np.asarray(ps.valid[s.n:])
        np.testing.assert_allclose(np.asarray(got)[vb], np.asarray(b)[vb],
                                   atol=1e-6)
        assert vb.shape[0] == nb

    def test_roundtrip(self, setup):
        params, s, spec = setup
        ps = plane_state_from_fluid(s, spec)
        out = fluid_state_from_planes(ps, s.n, params, spec)
        np.testing.assert_allclose(np.asarray(out.pos), np.asarray(s.pos),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.vel), np.asarray(s.vel),
                                   atol=1e-6)


class TestPcisphResident:
    @pytest.mark.slow
    def test_skin_zero_matches_per_step(self, setup):
        from dieselfluid_tpu.solvers.dense_resident import (
            dense_pcisph_resident_step,
        )
        from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step
        from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

        params, s, spec = setup
        delta = compute_pci_delta(params, 0.125)
        ps = plane_state_from_fluid(s, spec)
        ref = s
        # Step 1 is BITWISE identical (measured dpos = 0.0): the two
        # paths run the same plane math on the same binning.
        ps, iters = dense_pcisph_resident_step(ps, params, spec, delta,
                                               skin=0.0)
        ref, diag = dense_pcisph_step(ref, params, spec, delta,
                                      warm_start=True)
        out = fluid_state_from_planes(ps, s.n, params, spec)
        np.testing.assert_allclose(np.asarray(out.pos),
                                   np.asarray(ref.pos), atol=1e-7)
        assert int(iters) == int(diag.iters)
        # Multi-step parity needs REGULAR dynamics: the stiff inflated-d0
        # fixture transitions to a chaotic compression blowup by step 3
        # (measured max|v| ~ 110 — ulp-level FMA differences between the
        # two compiled programs then diverge arbitrarily). The calibrated
        # equilibrium config is well-posed; three frames stay tight.
        from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density

        n3, extent = 8, 0.5
        dx = (2.0 / n3) * extent
        cparams = lattice_rest_density(dx, FluidParams.for_spacing(dx))
        cs = dam_break_state(n3, cparams, extent=extent)
        cspec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), cparams.h,
                                         capacity=16)
        cdelta = compute_pci_delta(cparams, dx)
        cps = plane_state_from_fluid(cs, cspec)
        cref = cs
        for _ in range(3):
            cps, _ = dense_pcisph_resident_step(cps, cparams, cspec,
                                                cdelta, skin=0.0)
            cref, _ = dense_pcisph_step(cref, cparams, cspec, cdelta,
                                        warm_start=True)
        cout = fluid_state_from_planes(cps, cs.n, cparams, cspec)
        np.testing.assert_allclose(np.asarray(cout.pos),
                                   np.asarray(cref.pos), atol=1e-5)
        assert int(cps.rebuilds) == 3

    def test_warm_pressure_survives_rebuild(self, setup):
        from dieselfluid_tpu.ops.cellops import gather_plane
        from dieselfluid_tpu.solvers.dense_resident import (
            dense_pcisph_resident_step,
        )
        from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

        params, s, spec = setup
        delta = compute_pci_delta(params, 0.125)
        ps = plane_state_from_fluid(s, spec)
        ps, _ = dense_pcisph_resident_step(ps, params, spec, delta,
                                           skin=0.0)   # forces a rebuild
        press = np.asarray(gather_plane(ps.planes["press"], ps.flat[:s.n]))
        ok = np.asarray(ps.valid[:s.n])
        # The inflated-d0 fixture compresses: warm pressure must be nonzero
        # somewhere AND have ridden through the rebuild's gather/scatter.
        assert press[ok].max() > 0.0

    def test_amortized_rebuilds(self):
        """Near-equilibrium config (production-style calibrated d0, resting
        start): displacements stay under the skin and the binning survives
        several frames. (The shared fixture deliberately inflates d0, which
        compresses hard enough to cross the skin every step — correct
        behavior, but it exercises the trigger, not the amortization.)"""
        from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
        from dieselfluid_tpu.solvers.dense_resident import (
            dense_pcisph_resident_step,
        )
        from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

        n3, extent = 8, 0.5
        dx = (2.0 / n3) * extent
        params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
        s = dam_break_state(n3, params, extent=extent)
        spec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                        capacity=16)
        delta = compute_pci_delta(params, dx)
        steps = 4
        ps = plane_state_from_fluid(s, spec)
        for _ in range(steps):
            ps, _ = dense_pcisph_resident_step(ps, params, spec, delta,
                                               skin=0.05)
        assert int(ps.rebuilds) < steps
        assert int(ps.overflow) == 0
        out = fluid_state_from_planes(ps, s.n, params, spec)
        assert np.all(np.isfinite(np.asarray(out.pos)))


@pytest.mark.slow
def test_unroll_iteration_gradient_bias():
    """Quantify the fixed-unroll gradient bias (round-4 verdict #8): the
    reverse-differentiable PCISPH scan at unroll_iters=3 vs the 5-iteration
    (pci_max_iters cap) oracle, at an agitated state.

    MEASURED (512 particles, CPU interpret, round 5):
        rel |g3-g5|/|g5| = 0.169,  rel |g4-g5|/|g5| = 0.094,
        cos(g3, g5) = 0.9856
    The bias shrinks with unroll length and the DIRECTION is essentially
    unbiased (cosine > 0.98), so unroll_iters=3 — matching the adaptive
    forward's sustained mean (2.9-3.8 iters) — keeps descent-quality
    gradients at 60% of the 5-iteration cost; that is the data behind the
    bench's default. Asserted at 2x the measured values."""
    from dieselfluid_tpu.neighbors.calibrate import lattice_rest_density
    from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step
    from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

    n3, extent = 8, 0.5
    dx = (2.0 / n3) * extent
    params = lattice_rest_density(dx, FluidParams.for_spacing(dx))
    state = dam_break_state(n3, params, extent=extent)
    delta = compute_pci_delta(params, dx)
    off = params.h / 4.0
    spec = DenseCellSpec.for_domain((-1 - off,) * 3, (1 + off,) * 3,
                                    params.h, capacity=16)
    s = state
    for _ in range(5):
        s, diag = dense_pcisph_step(s, params, spec, delta,
                                    warm_start=True)

    def loss_of(unroll):
        def loss(pos):
            nxt, _ = dense_pcisph_step(
                s._replace(pos=pos), params, spec, delta,
                unroll_for_grad=True, unroll_iters=unroll)
            return jnp.sum(jnp.sin(3.0 * nxt.pos))
        return loss

    g3 = jax.grad(loss_of(3))(s.pos)
    g5 = jax.grad(loss_of(5))(s.pos)
    n5 = float(jnp.linalg.norm(g5))
    rel = float(jnp.linalg.norm(g3 - g5)) / n5
    cos = float(jnp.sum(g3 * g5)) / (float(jnp.linalg.norm(g3)) * n5)
    assert np.isfinite(rel) and np.isfinite(cos)
    assert rel < 0.35, rel          # 2x measured 0.169
    assert cos > 0.95, cos          # measured 0.9856
