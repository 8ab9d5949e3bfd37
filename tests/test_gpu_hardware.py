"""Card-only tests: the dense pipeline compiled for an NVIDIA GPU.

Interpret-mode green is not hardware green: these tests compile and run the
Triton stencil sweep, forward AND backward, on the card. They carry the
`gpu` marker and skip (inside the `gpu_device` fixture) where JAX has no GPU.

Run on the card with:  python -m pytest -m gpu tests/test_gpu_hardware.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_device")]


@pytest.fixture(scope="module")
def setup():
    from dieselfluid_tpu.config import FluidParams
    from dieselfluid_tpu.models.particles import dam_break_state
    from dieselfluid_tpu.ops.cellops import DenseCellSpec

    n3, extent = 8, 0.5
    dx = (2.0 / n3) * extent
    params = FluidParams.for_spacing(dx)
    s = dam_break_state(n3, params, extent=extent)
    key = jax.random.PRNGKey(0)
    s = s._replace(vel=jax.random.normal(key, s.vel.shape) * 0.1)
    params = params.replace(d0=float(1.1 * params.d0))
    spec = DenseCellSpec.for_domain((-1, -1, -1), (1, 1, 1), params.h,
                                    capacity=16)
    return params, s, spec


class TestCompiledKernels:
    def test_wcsph_forward_matches_oracle(self, setup):
        from dieselfluid_tpu.models import field as F
        from dieselfluid_tpu.neighbors.bruteforce import brute_force_neighborhood
        from dieselfluid_tpu.solvers.dense_step import dense_density_forces

        params, s, spec = setup
        rho, press, force, ovf = jax.jit(
            lambda st: dense_density_forces(st, params, spec))(s)
        nb = brute_force_neighborhood(s.pos, s.pos, params.h, 96)
        rho_o = np.asarray(F.density_with_self(s.pos, nb, params))
        np.testing.assert_allclose(np.asarray(rho), rho_o, rtol=1e-4)

    def test_wcsph_grad_matches_xla_path(self, setup):
        """The COMPILED backward on the card, pinned against the XLA gather
        path's autodiff."""
        from dieselfluid_tpu.neighbors.bruteforce import brute_force_neighborhood
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

        gp_d, gv_d = jax.jit(jax.grad(loss_dense, argnums=(0, 1)))(s.pos, s.vel)
        gp_x, gv_x = jax.jit(jax.grad(loss_xla, argnums=(0, 1)))(s.pos, s.vel)
        scale = float(jnp.abs(gp_x).max())
        np.testing.assert_allclose(np.asarray(gp_d) / scale,
                                   np.asarray(gp_x) / scale, atol=2e-4)
        vscale = float(jnp.abs(gv_x).max())
        np.testing.assert_allclose(np.asarray(gv_d) / vscale,
                                   np.asarray(gv_x) / vscale, atol=2e-4)

    def test_pcisph_materials_grad_finite(self, setup):
        """Compiled reverse-mode through the PCISPH correction scan with
        traced materials, on hardware."""
        from dieselfluid_tpu.models.materials import Materials
        from dieselfluid_tpu.solvers.dense_step import dense_pcisph_step
        from dieselfluid_tpu.solvers.pcisph import compute_pci_delta

        params, s, spec = setup
        mats = Materials.from_params(params)
        delta = compute_pci_delta(params, 2.0 / 8 * 0.5)

        def loss(m):
            nxt, _ = dense_pcisph_step(s, params, spec, delta, materials=m,
                                       unroll_for_grad=True)
            return jnp.sum(nxt.pos**2)

        g = jax.jit(jax.grad(loss))(mats)
        for f in ("mu", "d0", "mass"):
            v = float(getattr(g, f))
            assert np.isfinite(v), (f, v)
        assert float(g.mu) != 0.0

    def test_triton_sweep_matches_xla_sweep(self, setup):
        """Every production pair function through the compiled Triton
        kernel agrees with the plain-XLA sweep on the card (fp32; the two
        sum the same terms in different orders)."""
        from dieselfluid_tpu.ops import pallas_sph as ps
        from dieselfluid_tpu.ops.cellops import build_planes, dense_indices
        from dieselfluid_tpu.ops.smoothing import KernelCoeffs

        params, s, spec = setup
        k = KernelCoeffs.build(params.h)
        flat, valid, _ = dense_indices(s.pos, spec)
        n = s.pos.shape[0]
        vals = {c: jax.random.uniform(jax.random.PRNGKey(i), (n,),
                                      minval=0.5, maxval=2.0)
                for i, c in enumerate(("rho", "press", "pq", "iv",
                                       "ct_0", "ct_1", "ct_2"))}
        vals.update(x=s.pos[:, 0], y=s.pos[:, 1], z=s.pos[:, 2],
                    vx=s.vel[:, 0], vy=s.vel[:, 1], vz=s.vel[:, 2])
        planes = build_planes(vals, flat, valid, spec)
        cases = [
            (ps._density_pair(k), ps._D_IN, 1, "density"),
            (ps._force_fold_pair(k, params.mass, params.mu),
             ps._F_IN_FOLD, 3, "force"),
            (ps._press_pq_pair(k), ps._PQ_IN, 3, "pressure"),
            (ps._bwd_pair(ps._force_pair(k, params.mass, params.mu), 3,
                          ps._F_GRAD),
             ps._F_IN + ("ct_0", "ct_1", "ct_2"), len(ps._F_GRAD), "force"),
        ]
        for pair, names, n_out, kind in cases:
            ins = [planes[c] for c in names]
            tri = jax.jit(lambda *a: ps._sweep(
                pair, names, n_out, a, spec, kind=kind))(*ins)
            ref = jax.jit(lambda *a: ps._sweep_xla(
                pair, names, n_out, a, spec))(*ins)
            for a, b in zip(tri, ref):
                scale = float(jnp.abs(b).max())
                np.testing.assert_allclose(np.asarray(a) / scale,
                                           np.asarray(b) / scale, atol=1e-5)

    def test_compiled_step_runs_the_triton_kernel(self, setup):
        from dieselfluid_tpu.solvers.dense_step import dense_wcsph_step

        params, s, spec = setup
        hlo = dense_wcsph_step.lower(s, params, spec).compile().as_text()
        assert "dense_stencil_sweep" in hlo
