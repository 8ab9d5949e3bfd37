"""Pallas sweep forward AND VJP vs an independent O(N^2) reference.

The reference implementations below re-derive the pair sums straight from
the kernel formulas (ref: data/shaders/opencl/include/pcisph.h
pressure_force/viscosity_force/particle_density) as plain jnp pairwise
einsums over random particle configurations — NOT via the repo's sweep
machinery — and jax.grad of that reference is the gradient oracle.

This caught a real round-4 bug the dense-vs-XLA comparison tests missed:
a sweep-accumulator restructure broadcast _bwd_pair's pre-reduced (bw, 1)
gradients across the (bw, ww) candidate window before the final lane
reduction, inflating EVERY backward-sweep gradient by exactly ww (x96).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dieselfluid_tpu.ops import pallas_sph as ps
from dieselfluid_tpu.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_plane,
    gather_planes,
)
from dieselfluid_tpu.ops.smoothing import KernelCoeffs

H = 0.25
N = 60
EPS = 1e-12


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    pos = jnp.asarray(rng.uniform(-0.45, 0.45, (N, 3)).astype(np.float32))
    vel = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
    rho = jnp.asarray(rng.uniform(80.0, 120.0, (N,)).astype(np.float32))
    press = jnp.asarray(rng.uniform(0.0, 5.0, (N,)).astype(np.float32))
    ct = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
    spec = DenseCellSpec.for_domain((-0.5,) * 3, (0.5,) * 3, H, capacity=16)
    k = KernelCoeffs.build(H)
    flat, valid, ovf = dense_indices(pos, spec)
    assert int(ovf) == 0
    return pos, vel, rho, press, ct, spec, k, flat, valid


def _pair_geom(p):
    dx = p[None, :, :] - p[:, None, :]          # cand - own
    d2 = jnp.sum(dx * dx, -1)
    live = (d2 > EPS) & (d2 < H * H)
    inv_d = jax.lax.rsqrt(jnp.where(live, d2, 1.0))
    return dx, d2, live, inv_d


def ref_density(p, k):
    _, d2, _, _ = _pair_geom(p)
    q = 1.0 - d2 / (H * H)
    w = jnp.where(d2 < H * H, float(k.a) * q * q, 0.0)
    return jnp.sum(w, axis=1)                   # includes the self term


def ref_press_force(p, r, pr, k):
    dx, d2, live, inv_d = _pair_geom(p)
    dist = d2 * inv_d
    q1 = 1.0 - dist / H
    o1d = float(k.b) * q1 * q1
    coeff = (pr[:, None] / jnp.maximum(r[:, None], EPS) ** 2
             + pr[None, :] / jnp.maximum(r[None, :], EPS) ** 2)
    s = jnp.where(live, coeff * o1d * inv_d, 0.0)
    return jnp.einsum("ij,ijc->ic", s, dx)


def ref_visc_force(p, v, r, k):
    dx, d2, live, inv_d = _pair_geom(p)
    dist = d2 * inv_d
    o2d = float(k.c) * (1.0 - dist / H)
    s = jnp.where(live, o2d / jnp.maximum(r[None, :], EPS), 0.0)
    dv = v[None, :, :] - v[:, None, :]
    return jnp.einsum("ij,ijc->ic", s, dv)


def _planes(vals, flat, valid, spec):
    return build_planes(vals, flat, valid, spec)


class TestDensity:
    def test_fwd_and_vjp(self, setup):
        pos, _, _, _, ct, spec, k, flat, valid = setup

        def sweep(p):
            planes = _planes({"x": p[:, 0], "y": p[:, 1], "z": p[:, 2]},
                             flat, valid, spec)
            return gather_plane(ps._density_sum(planes, spec, k), flat)

        f = sweep(pos)
        g = jax.grad(lambda p: jnp.sum(sweep(p) * ct[:, 0]))(pos)
        f_r = ref_density(pos, k)
        g_r = jax.grad(lambda p: jnp.sum(ref_density(p, k) * ct[:, 0]))(pos)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_r),
                                   rtol=2e-5)
        scale = float(jnp.abs(g_r).max())
        np.testing.assert_allclose(np.asarray(g) / scale,
                                   np.asarray(g_r) / scale, atol=2e-5)


class TestPressureForce:
    def test_fwd_and_vjp(self, setup):
        pos, _, rho, press, ct, spec, k, flat, valid = setup

        def sweep(p, r, pr):
            planes = _planes({"x": p[:, 0], "y": p[:, 1], "z": p[:, 2]},
                             flat, valid, spec)
            rp = _planes({"v": r}, flat, valid, spec)["v"]
            pp = _planes({"v": pr}, flat, valid, spec)["v"]
            fx, fy, fz = ps._press_sum(planes, rp, pp, spec, k)
            return gather_planes([fx, fy, fz], flat)

        args = (pos, rho, press)
        f = sweep(*args)
        g = jax.grad(lambda *a: jnp.sum(sweep(*a) * ct),
                     argnums=(0, 1, 2))(*args)
        f_r = ref_press_force(*args, k)
        g_r = jax.grad(lambda *a: jnp.sum(ref_press_force(*a, k) * ct),
                       argnums=(0, 1, 2))(*args)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_r),
                                   atol=2e-6 * float(jnp.abs(f_r).max()))
        for name, a, b in zip(("pos", "rho", "press"), g, g_r):
            scale = float(jnp.abs(b).max())
            np.testing.assert_allclose(
                np.asarray(a) / scale, np.asarray(b) / scale, atol=3e-5,
                err_msg=f"pressure-force vjp mismatch: d {name}")


class TestViscosityForce:
    def test_fwd_and_vjp(self, setup):
        pos, vel, rho, _, ct, spec, k, flat, valid = setup

        def sweep(p, v, r):
            planes = _planes(
                {"x": p[:, 0], "y": p[:, 1], "z": p[:, 2],
                 "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2]},
                flat, valid, spec)
            rp = _planes({"v": r}, flat, valid, spec)["v"]
            fx, fy, fz = ps._visc_sum(planes, rp, spec, k)
            return gather_planes([fx, fy, fz], flat)

        args = (pos, vel, rho)
        f = sweep(*args)
        g = jax.grad(lambda *a: jnp.sum(sweep(*a) * ct),
                     argnums=(0, 1, 2))(*args)
        f_r = ref_visc_force(*args, k)
        g_r = jax.grad(lambda *a: jnp.sum(ref_visc_force(*a, k) * ct),
                       argnums=(0, 1, 2))(*args)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_r),
                                   atol=2e-6 * float(jnp.abs(f_r).max()))
        for name, a, b in zip(("pos", "vel", "rho"), g, g_r):
            scale = float(jnp.abs(b).max())
            np.testing.assert_allclose(
                np.asarray(a) / scale, np.asarray(b) / scale, atol=3e-5,
                err_msg=f"viscosity vjp mismatch: d {name}")


# `_sweep_xla` itself (the CPU lowering and the reference the Triton kernel
# is checked against), forward and VJP, on odd and non-cubic cell grids and
# every slot capacity the layout is used with.
GRIDS = {
    "odd-cubic": ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), 0.2),   # 5x5x5 cells
    "non-cubic": ((-0.5, -0.3, -0.45), (0.5, 0.3, 0.45), 0.25),  # 4x3x4
}


def _grid_case(grid, capacity):
    lo, hi, h = GRIDS[grid]
    rng = np.random.RandomState(capacity)
    inner = np.asarray(hi) - 0.05
    pos = jnp.asarray(rng.uniform(-inner, inner, (N, 3)).astype(np.float32))
    rho = jnp.asarray(rng.uniform(80.0, 120.0, (N,)).astype(np.float32))
    press = jnp.asarray(rng.uniform(0.0, 5.0, (N,)).astype(np.float32))
    ct = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
    spec = DenseCellSpec.for_domain(lo, hi, h, capacity=capacity)
    flat, valid, ovf = dense_indices(pos, spec)
    assert int(ovf) == 0
    return pos, rho, press, ct, spec, KernelCoeffs.build(h), flat, valid, h


def _oracle_density(p, h, k):
    d2 = jnp.sum((p[None, :, :] - p[:, None, :]) ** 2, -1)
    q = 1.0 - d2 / (h * h)
    return jnp.sum(jnp.where(d2 < h * h, float(k.a) * q * q, 0.0), axis=1)


def _oracle_press(p, r, pr, h, k):
    dx = p[None, :, :] - p[:, None, :]
    d2 = jnp.sum(dx * dx, -1)
    live = (d2 > EPS) & (d2 < h * h)
    inv_d = jax.lax.rsqrt(jnp.where(live, d2, 1.0))
    q1 = 1.0 - d2 * inv_d / h
    coeff = (pr[:, None] / jnp.maximum(r[:, None], EPS) ** 2
             + pr[None, :] / jnp.maximum(r[None, :], EPS) ** 2)
    s = jnp.where(live, coeff * float(k.b) * q1 * q1 * inv_d, 0.0)
    return jnp.einsum("ij,ijc->ic", s, dx)


@pytest.mark.parametrize("capacity", [8, 16, 32])
@pytest.mark.parametrize("grid", sorted(GRIDS))
class TestSweepXlaGrids:
    def test_density_fwd_and_vjp(self, grid, capacity):
        pos, _, _, ct, spec, k, flat, valid, h = _grid_case(grid, capacity)
        vals = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
                "ct_0": ct[:, 0]}
        planes = build_planes(vals, flat, valid, spec)
        (rho,) = ps._sweep_xla(ps._density_pair(k), ps._D_IN, 1,
                               [planes[n] for n in ps._D_IN], spec)
        np.testing.assert_allclose(
            np.asarray(gather_plane(rho, flat)),
            np.asarray(_oracle_density(pos, h, k)), rtol=2e-5)

        names = ps._D_IN + ("ct_0",)
        grads = ps._sweep_xla(
            ps._bwd_pair(ps._density_pair(k), 1, ("x", "y", "z")), names, 3,
            [planes[n] for n in names], spec)
        g = gather_planes(grads, flat)
        g_r = jax.grad(lambda p: jnp.sum(
            _oracle_density(p, h, k) * ct[:, 0]))(pos)
        scale = float(jnp.abs(g_r).max())
        np.testing.assert_allclose(np.asarray(g) / scale,
                                   np.asarray(g_r) / scale, atol=2e-5)

    def test_pressure_fwd_and_vjp(self, grid, capacity):
        pos, rho, press, ct, spec, k, flat, valid, h = _grid_case(
            grid, capacity)
        vals = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
                "rho": rho, "press": press,
                "ct_0": ct[:, 0], "ct_1": ct[:, 1], "ct_2": ct[:, 2]}
        planes = build_planes(vals, flat, valid, spec)
        f = gather_planes(ps._sweep_xla(
            ps._press_pair(k), ps._P_IN, 3, [planes[n] for n in ps._P_IN],
            spec), flat)
        f_r = _oracle_press(pos, rho, press, h, k)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_r),
                                   atol=2e-6 * float(jnp.abs(f_r).max()))

        names = ps._P_IN + ("ct_0", "ct_1", "ct_2")
        grads = ps._sweep_xla(
            ps._bwd_pair(ps._press_pair(k), 3, ps._P_GRAD), names,
            len(ps._P_GRAD), [planes[n] for n in names], spec)
        g = dict(zip(ps._P_GRAD, grads))
        g_r = jax.grad(lambda p, r, pr: jnp.sum(
            _oracle_press(p, r, pr, h, k) * ct), argnums=(0, 1, 2))(
                pos, rho, press)
        got = (gather_planes([g["x"], g["y"], g["z"]], flat),
               gather_plane(g["rho"], flat), gather_plane(g["press"], flat))
        for name, a, b in zip(("pos", "rho", "press"), got, g_r):
            scale = float(jnp.abs(b).max())
            np.testing.assert_allclose(
                np.asarray(a) / scale, np.asarray(b) / scale, atol=3e-5,
                err_msg=f"{grid}/{capacity}: pressure vjp d {name}")
