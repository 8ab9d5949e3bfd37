"""Dense-cell stencil sweeps vs the XLA oracle.

On the CPU the production sweep lowers to the plain-XLA `_sweep_xla`; the
Triton kernel runs here in Pallas interpret mode against it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models import field as F
from dieselfluid_tpu.models.particles import dam_break_state
from dieselfluid_tpu.neighbors.bruteforce import brute_force_neighborhood
from dieselfluid_tpu.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_plane,
)
from dieselfluid_tpu.ops.smoothing import tait_eos
from dieselfluid_tpu.solvers.dense_step import dense_density_forces


@pytest.fixture(scope="module")
def setup():
    n3, extent = 8, 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    s = dam_break_state(n3, params, extent=extent)
    key = jax.random.PRNGKey(0)
    s = s._replace(vel=jax.random.normal(key, s.vel.shape) * 0.1)
    params = params.replace(d0=float(1.1 * params.d0))
    spec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h, capacity=16)
    return params, s, spec


class TestDenseLayout:
    def test_indices_unique_and_valid(self, setup):
        params, s, spec = setup
        flat, valid, overflow = dense_indices(s.pos, spec)
        assert int(overflow) == 0
        f = np.asarray(flat)[np.asarray(valid)]
        assert len(np.unique(f)) == len(f), "slot collision"
        assert f.min() >= 0 and f.max() < spec.rows * spec.row_len

    def test_plane_roundtrip(self, setup):
        params, s, spec = setup
        flat, valid, _ = dense_indices(s.pos, spec)
        planes = build_planes({"x": s.pos[:, 0]}, flat, valid, spec)
        back = gather_plane(planes["x"], flat)
        np.testing.assert_allclose(np.asarray(back), np.asarray(s.pos[:, 0]), atol=1e-6)
        # mask plane sums to the particle count
        assert float(planes["mask"].sum()) == s.n

    def test_capacity_overflow_counted(self, setup):
        params, s, spec = setup
        tight = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h, capacity=1)
        _, valid, overflow = dense_indices(s.pos, tight)
        assert int(overflow) > 0
        assert int(overflow) + int(np.asarray(valid).sum()) == s.n


class TestOverflowFallback:
    def test_pcisph_overflowed_particles_get_gravity_only(self, setup):
        """An overflowed particle's clamped slot aliases a VALID neighbor's
        slot; every gather must mask it out so it falls back to rho=d0 and
        gravity-only force — NOT the neighbor's physics (round-2 weak #4)."""
        from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step
        from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

        params, s, spec = setup
        tight = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                         capacity=2)
        _, valid, overflow = dense_indices(s.pos, tight)
        assert int(overflow) > 0, "test needs overflow to exercise the path"
        delta = compute_pci_delta(params, 2.0 / 8 * 0.5)
        nxt, diag = dense_pcisph_step(s, params, tight, delta,
                                      bounds=None)
        assert int(diag.overflow) == int(overflow)
        inval = ~np.asarray(valid)
        gravity = np.asarray(params.gravity, np.float32) * params.mass
        np.testing.assert_allclose(np.asarray(nxt.density)[inval], params.d0,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(nxt.force)[inval],
                                   np.broadcast_to(gravity, (inval.sum(), 3)),
                                   atol=1e-6)
        assert np.isfinite(np.asarray(nxt.pos)).all()


class TestGradients:
    """The Pallas path's custom VJP vs the XLA gather path's autodiff.

    Both paths share forward semantics (tested below), and both treat the
    neighbor structure as fixed, so end-to-end step gradients must agree.
    This is the round-1 north-star gap: the fast path now differentiates
    (ref capability analog: none — the reference has no autodiff at all).
    """

    def test_step_grad_matches_xla_path(self, setup):
        from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step
        from dieselfluid_tpu.solvers.wcsph import wcsph_step

        params, s, spec = setup
        key = jax.random.PRNGKey(7)
        w_pos = jax.random.normal(key, s.pos.shape)

        def loss_dense(pos, vel):
            st = s._replace(pos=pos, vel=vel)
            nxt, _ = dense_wcsph_step(st, params, spec)
            return jnp.sum(nxt.pos * w_pos) + jnp.sum(nxt.vel**2)

        def loss_xla(pos, vel):
            st = s._replace(pos=pos, vel=vel)
            nfn = lambda p: brute_force_neighborhood(p, p, params.h, 96)
            nxt, _ = wcsph_step(st, params, neighbor_fn=nfn)
            return jnp.sum(nxt.pos * w_pos) + jnp.sum(nxt.vel**2)

        gp_d, gv_d = jax.grad(loss_dense, argnums=(0, 1))(s.pos, s.vel)
        gp_x, gv_x = jax.grad(loss_xla, argnums=(0, 1))(s.pos, s.vel)
        scale = float(jnp.abs(gp_x).max())
        np.testing.assert_allclose(np.asarray(gp_d) / scale,
                                   np.asarray(gp_x) / scale, atol=1e-4)
        vscale = float(jnp.abs(gv_x).max())
        np.testing.assert_allclose(np.asarray(gv_d) / vscale,
                                   np.asarray(gv_x) / vscale, atol=1e-4)


class TestMaterialsGradients:
    """Traced Materials on the dense production path (BASELINE config 4):
    factored kernels apply mass/mu/d0/gamma/w outside the sweeps, so their
    gradients flow through plain XLA around the custom-VJP plane ops."""

    @pytest.mark.slow
    def test_dense_wcsph_materials_grad_matches_xla(self, setup):
        from dieselfluid_tpu.models.materials import Materials
        from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step
        from dieselfluid_tpu.solvers.wcsph import wcsph_step

        params, s, spec = setup
        mats = Materials.from_params(params)
        key = jax.random.PRNGKey(3)
        w_pos = jax.random.normal(key, s.pos.shape)

        def loss_dense(m):
            nxt, _ = dense_wcsph_step(s, params, spec, materials=m)
            return jnp.sum(nxt.pos * w_pos)

        def loss_xla(m):
            nfn = lambda p: brute_force_neighborhood(p, p, params.h, 96)
            nxt, _ = wcsph_step(s, params, neighbor_fn=nfn, materials=m)
            return jnp.sum(nxt.pos * w_pos)

        g_d = jax.grad(loss_dense)(mats)
        g_x = jax.grad(loss_xla)(mats)
        # The XLA path does not trace mass (compute_forces bakes params.mass)
        # so compare the fields both paths trace: mu, d0, gamma, w.
        for f in ("mu", "d0", "tait_gamma", "tait_w"):
            d, x = float(getattr(g_d, f)), float(getattr(g_x, f))
            assert np.isfinite(d)
            np.testing.assert_allclose(d, x, rtol=5e-3, err_msg=f)

    @pytest.mark.slow
    def test_dense_pcisph_unroll_grad_matches_xla(self, setup):
        """Reverse-mode through the fixed-iteration PCISPH scan: traced mu/d0
        gradients on the dense Pallas path vs the XLA gather path (both
        autodiff with the same clamp subgradient convention — an FD oracle is
        unreliable here because the max(p, 0) clamp makes the loss kinked)."""
        from dieselfluid_tpu.models.materials import Materials
        from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step
        from dieselfluid_tpu.solvers.pcisph import compute_pci_delta, pcisph_step

        params, s, spec = setup
        mats = Materials.from_params(params)
        delta = compute_pci_delta(params, 2.0 / 8 * 0.5)
        key = jax.random.PRNGKey(11)
        w_pos = jax.random.normal(key, s.pos.shape)

        def loss_dense(m):
            nxt, _ = dense_pcisph_step(s, params, spec, delta, materials=m,
                                       unroll_for_grad=True)
            return jnp.sum(nxt.pos * w_pos)

        def loss_xla(m):
            nfn = lambda p: brute_force_neighborhood(p, p, params.h, 96)
            nxt, _ = pcisph_step(s, params, delta, neighbor_fn=nfn,
                                 unroll_for_grad=True, materials=m)
            return jnp.sum(nxt.pos * w_pos)

        g_d = jax.grad(loss_dense)(mats)
        g_x = jax.grad(loss_xla)(mats)
        for f in ("mu", "d0"):
            d, x = float(getattr(g_d, f)), float(getattr(g_x, f))
            assert np.isfinite(d), f
            np.testing.assert_allclose(d, x, rtol=1e-2, err_msg=f)

    @pytest.mark.slow
    def test_dense_wcsph_mass_grad_fd(self, setup):
        """Full traced-mass gradient (kernels + gravity + integrator) pinned
        by central finite differences on the smooth WCSPH step."""
        from dieselfluid_tpu.models.materials import Materials
        from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step

        params, s, spec = setup
        mats = Materials.from_params(params)
        key = jax.random.PRNGKey(5)
        w_pos = jax.random.normal(key, s.pos.shape)

        def loss(m):
            nxt, _ = dense_wcsph_step(s, params, spec, materials=m)
            return jnp.sum(nxt.pos * w_pos)

        g = float(jax.grad(loss)(mats).mass)
        v0 = float(mats.mass)
        eps = v0 * 1e-2
        lp = float(loss(mats._replace(mass=jnp.float32(v0 + eps))))
        lm = float(loss(mats._replace(mass=jnp.float32(v0 - eps))))
        fd = (lp - lm) / (2 * eps)
        assert np.isfinite(g)
        np.testing.assert_allclose(g, fd, rtol=5e-2)


class TestKernelsInterpreted:
    def test_density_forces_match_oracle(self, setup):
        params, s, spec = setup
        rho, press, force, ovf = dense_density_forces(s, params, spec)
        rho, force = np.asarray(rho), np.asarray(force)

        nb = brute_force_neighborhood(s.pos, s.pos, params.h, 96)
        rho_o = F.density_with_self(s.pos, nb, params)
        press_o = tait_eos(rho_o, params.d0, params.p0, params.tait_gamma, params.tait_w)
        f_o = np.asarray(
            F.pressure_force(s.pos, rho_o, press_o, nb, params)
            + params.mu * F.laplacian_force(s.pos, s.vel, rho_o, nb, params)
        )
        np.testing.assert_allclose(rho, np.asarray(rho_o), rtol=1e-5)
        scale = np.abs(f_o).max()
        np.testing.assert_allclose(force / scale, f_o / scale, atol=1e-5)

    @pytest.mark.parametrize("n3,domain", [
        (6, 1.0),    # small grid: every column touches the ghost ring
        (8, 1.375),  # odd, non-power-of-two column counts
    ])
    def test_density_matches_oracle_on_odd_grids(self, n3, domain):
        """Grids whose column counts are small or odd must still match the
        oracle at every edge of the sweep's column loop."""
        dx = (2.0 / n3) * 0.5
        params = FluidParams.for_spacing(dx)
        s = dam_break_state(n3, params, extent=0.5)
        params = params.replace(d0=float(1.1 * params.d0))
        spec = DenseCellSpec.for_domain((-domain,) * 3, (domain,) * 3,
                                        params.h, capacity=16)
        rho, _, force, ovf = dense_density_forces(s, params, spec)
        assert int(ovf) == 0
        nb = brute_force_neighborhood(s.pos, s.pos, params.h, 96)
        rho_o = F.density_with_self(s.pos, nb, params)
        np.testing.assert_allclose(np.asarray(rho), np.asarray(rho_o),
                                   rtol=1e-5)



# ---------------------------------------------------------------------------
# The Triton sweep (interpret mode) against `_sweep_xla`
# ---------------------------------------------------------------------------


def _random_planes(spec, seed=0, n=80, half=0.45):
    from dieselfluid_tpu.ops.cellops import build_planes, dense_indices

    rng = np.random.RandomState(seed)
    pos = jnp.asarray(rng.uniform(-half, half, (n, 3)).astype(np.float32))
    vals = {c: jnp.asarray(rng.uniform(0.5, 2.0, (n,)).astype(np.float32))
            for c in ("vx", "vy", "vz", "rho", "press", "pq", "iv",
                      "ct_0", "ct_1", "ct_2")}
    vals.update(x=pos[:, 0], y=pos[:, 1], z=pos[:, 2])
    flat, valid, ovf = dense_indices(pos, spec)
    assert int(ovf) == 0
    return build_planes(vals, flat, valid, spec)


def _sweep_cases(k):
    from dieselfluid_tpu.ops import pallas_sph as ps

    return {
        "density": (ps._density_pair(k), ps._D_IN, 1),
        "fused_force": (ps._force_fold_pair(k, 0.01, 0.1), ps._F_IN_FOLD, 3),
        "fused_force_pressure_only": (ps._force_fold_pair(k, 0.01, 0.0),
                                      ps._F_IN_FOLD_P, 3),
        "pq_pressure": (ps._press_pq_pair(k), ps._PQ_IN, 3),
        "pressure": (ps._press_pair(k), ps._P_IN, 3),
        "viscosity": (ps._visc_pair(k), ps._V_IN, 3),
        "density_vjp": (ps._bwd_pair(ps._density_pair(k), 1,
                                     ("x", "y", "z")),
                        ps._D_IN + ("ct_0",), 3),
        "force_vjp": (ps._bwd_pair(ps._force_pair(k, 0.01, 0.1), 3,
                                   ps._F_GRAD),
                      ps._F_IN + ("ct_0", "ct_1", "ct_2"), len(ps._F_GRAD)),
    }


_SWEEP_NAMES = ("density", "fused_force", "fused_force_pressure_only",
                "pq_pressure", "pressure", "viscosity", "density_vjp",
                "force_vjp")


class TestTritonSweepInterpreted:
    @pytest.mark.parametrize("launch", ["density", "pressure", "force"])
    @pytest.mark.parametrize("case", _SWEEP_NAMES)
    def test_matches_sweep_xla(self, case, launch):
        """Every pair function under every production launch (own block,
        warps, wide or per-window accumulation)."""
        from dieselfluid_tpu.ops import pallas_sph as ps
        from dieselfluid_tpu.ops.smoothing import KernelCoeffs

        h = 0.25
        spec = DenseCellSpec.for_domain((-0.5,) * 3, (0.5,) * 3, h,
                                        capacity=16)
        pair, names, n_out = _sweep_cases(KernelCoeffs.build(h))[case]
        ins = [_random_planes(spec)[c] for c in names]
        block, num_warps, wide = ps._TRITON_LAUNCH[launch]
        want = ps._sweep_xla(pair, names, n_out, ins, spec)
        got = ps._sweep_triton(pair, names, n_out, ins, spec, block=block,
                               num_warps=num_warps, wide=wide,
                               interpret=True)
        assert len(got) == n_out
        for a, b in zip(got, want):
            assert a.shape == spec.plane_shape
            scale = float(jnp.abs(b).max())
            np.testing.assert_allclose(np.asarray(a) / scale,
                                       np.asarray(b) / scale, atol=1e-6)

    @pytest.mark.parametrize("wide", [False, True])
    @pytest.mark.parametrize("capacity,block", [(8, 32), (32, 32), (32, 64)])
    def test_block_layouts(self, capacity, block, wide):
        """Own blocks of several cells (capacity 8), one cell (capacity 32,
        block 32) and two cells (block 64) on a non-cubic, odd grid."""
        from dieselfluid_tpu.ops import pallas_sph as ps
        from dieselfluid_tpu.ops.smoothing import KernelCoeffs

        h = 0.2
        spec = DenseCellSpec.for_domain((-0.5, -0.3, -0.5), (0.5, 0.3, 0.5),
                                        h, capacity=capacity)
        pair, names, n_out = _sweep_cases(KernelCoeffs.build(h))["density"]
        ins = [_random_planes(spec, seed=capacity, half=0.25)[c]
               for c in names]
        (want,) = ps._sweep_xla(pair, names, n_out, ins, spec)
        (got,) = ps._sweep_triton(pair, names, n_out, ins, spec, block=block,
                                  wide=wide, interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)


def test_sweep_choice_is_made_at_lowering():
    """`_sweep` lowers to the Triton custom call for CUDA and to plain XLA
    for the CPU, from one traced program — no run-time device check."""
    from dieselfluid_tpu.ops import pallas_sph as ps
    from dieselfluid_tpu.ops.smoothing import KernelCoeffs

    h = 0.25
    spec = DenseCellSpec.for_domain((-0.5,) * 3, (0.5,) * 3, h, capacity=16)
    pair, names, n_out = _sweep_cases(KernelCoeffs.build(h))["density"]
    ins = [_random_planes(spec)[c] for c in names]
    traced = jax.jit(lambda *p: ps._sweep(pair, names, n_out, p,
                                          spec)).trace(*ins)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "xla.gpu.triton" in cuda and "dense_stencil_sweep" in cuda
    assert "xla.gpu.triton" not in cpu
