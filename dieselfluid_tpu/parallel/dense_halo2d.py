"""2-D (x, y) slab decomposition for the dense Pallas pipeline.

parallel/dense_halo.py decomposes the domain into 1-D x-slabs — past a few
devices the surface/volume ratio stops improving and a dam break
concentrates its mass in a handful of x slabs (the per-slab live-count
diagnostic makes this visible). This module decomposes over a 2-D
(AXIS_X, AXIS_Y) device mesh: each shard owns an nxd x nyd block of whole
cell columns, so both decomposed axes scale.

Halo protocol (the dense layout's ghost ring covers BOTH x and y —
cellops rows = (nx+2) * (ny+2)):

  1. y-exchange: each shard ppermutes its owned first/last y ROWS (strided
     row gathers, one (nx+2, sub, 128) slab per direction) over AXIS_Y into
     the neighbors' y ghost rows, then shifts their local y by +-slab_w_y.
  2. x-exchange: the existing whole-column exchange over AXIS_X ships
     (ny+2)-row blocks — which now INCLUDE the already-filled y ghost rows,
     so the four diagonal corner cells arrive through the x neighbor with
     the correct y shift (the x neighbor shares this shard's y frame).
     Standard 2-phase corner forwarding; no diagonal ppermute needed.

Owner-computed rho/pressure ghosts run the same y-then-x sequence, and
migration runs one _migrate pass per dimension. Both WCSPH and PCISPH
(with boundary stores) are implemented — parity-tested against the
single-chip dense step (round-3 verdict, next-step #7; the 1-D dense path
remains the default production decomposition).

ref: the reference is single-device (SURVEY §2.11); this has no analog.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dieselfluid_tpu.config import FluidParams
from dieselfluid_tpu.models.particles import FluidState
from dieselfluid_tpu.ops.cellops import (
    DenseCellSpec,
    build_planes,
    dense_indices,
    gather_planes,
)
from dieselfluid_tpu.ops.pallas_sph import (
    density_planes,
    force_planes,
)
from dieselfluid_tpu.ops.smoothing import KernelCoeffs, tait_eos
from dieselfluid_tpu.parallel.dense_halo import (
    _exchange_ghost_columns,
    _shift_ghost_x,
)
from dieselfluid_tpu.parallel.halo import SlabState, _migrate
from dieselfluid_tpu.solvers.integrate import box_collide, semi_implicit_euler

AXIS_X = "sp"
AXIS_Y = "spy"


@dataclasses.dataclass(frozen=True)
class DenseSlab2DSpec:
    """nx_dev * ny_dev shards, each owning nxd x nyd whole cell columns."""

    nx_dev: int
    ny_dev: int
    capacity: int
    migrate_capacity: int
    cell: float
    nxd: int
    nyd: int
    lo: float = -1.0
    hi_z: float = 1.0
    cell_capacity: int = 16

    @staticmethod
    def build(nx_dev: int, ny_dev: int, h: float, capacity: int,
              migrate_capacity: int, lo: float = -1.0, hi: float = 1.0,
              cell_capacity: int = 16) -> "DenseSlab2DSpec":
        nxd = max(1, int(-(-((hi - lo) / nx_dev) // h)))
        nyd = max(1, int(-(-((hi - lo) / ny_dev) // h)))
        return DenseSlab2DSpec(nx_dev=nx_dev, ny_dev=ny_dev,
                               capacity=capacity,
                               migrate_capacity=migrate_capacity,
                               cell=float(h), nxd=nxd, nyd=nyd, lo=lo,
                               hi_z=hi, cell_capacity=cell_capacity)

    @staticmethod
    def build_for_state(state, nx_dev: int, ny_dev: int, h: float,
                        migrate_capacity: int, lo: float = -1.0,
                        hi: float = 1.0, cell_capacity: int = 16,
                        headroom: float = 2.0) -> "DenseSlab2DSpec":
        """Like `build`, but the per-shard store capacity is DERIVED from
        the initial occupancy histogram (+ headroom for migration and
        transients), rounded up to a multiple of 64 — instead of a
        hand-tuned constant that silently drops particles on a skewed
        scene (round-4 verdict, next-step #7; fixed-capacity contract
        analog ref: sampler/lsh/lsh.go:30-52)."""
        import numpy as np

        probe = DenseSlab2DSpec.build(nx_dev, ny_dev, h, capacity=1,
                                      migrate_capacity=migrate_capacity,
                                      lo=lo, hi=hi,
                                      cell_capacity=cell_capacity)
        pos = np.asarray(state.pos)
        bx = np.clip(((pos[:, 0] - lo) / probe.slab_w_x).astype(int),
                     0, nx_dev - 1)
        by = np.clip(((pos[:, 1] - lo) / probe.slab_w_y).astype(int),
                     0, ny_dev - 1)
        counts = np.bincount(bx * ny_dev + by, minlength=nx_dev * ny_dev)
        cap = max(64, int(-(-counts.max() * headroom // 64)) * 64)
        return dataclasses.replace(probe, capacity=cap)

    @property
    def slab_w_x(self) -> float:
        return self.nxd * self.cell

    @property
    def slab_w_y(self) -> float:
        return self.nyd * self.cell

    @property
    def hi_x(self) -> float:
        return self.lo + self.nx_dev * self.slab_w_x

    @property
    def hi_y(self) -> float:
        return self.lo + self.ny_dev * self.slab_w_y

    @property
    def local_spec(self) -> DenseCellSpec:
        base = DenseCellSpec.for_domain(
            (0.0, 0.0, self.lo),
            (self.slab_w_x, self.slab_w_y, self.hi_z + 3.0 * self.cell),
            self.cell, capacity=self.cell_capacity)
        return dataclasses.replace(base, nx=self.nxd, ny=self.nyd)

    @property
    def park_z(self) -> float:
        return self.hi_z + 2.5 * self.cell


def make_mesh_2d(nx_dev: int, ny_dev: int):
    return jax.make_mesh((nx_dev, ny_dev), (AXIS_X, AXIS_Y))


# ---------------------------------------------------------------------------
# y ghost-row exchange
# ---------------------------------------------------------------------------


def _exchange_ghost_rows_y(plane, spec: DenseCellSpec, axis=AXIS_Y):
    """Fill the y ghost rows (j = 0 and j = ny+1 within every x block) from
    the AXIS_Y neighbors' owned edge rows. Strided gathers: one
    (nx+2, sub, 128) slab per direction."""
    py = spec.py
    n = jax.lax.axis_size(axis)
    idx = jnp.arange(spec.nx + 2) * py
    to_right = [(i, i + 1) for i in range(n - 1)]
    to_left = [(i + 1, i) for i in range(n - 1)]
    from_left = jax.lax.ppermute(plane[idx + spec.ny], axis, to_right)
    from_right = jax.lax.ppermute(plane[idx + 1], axis, to_left)
    plane = plane.at[idx].set(from_left)
    plane = plane.at[idx + spec.ny + 1].set(from_right)
    return plane


def _shift_ghost_y(planes: dict, spec: DenseCellSpec, slab_w_y: float):
    """Localize received y-ghost rows: their y is the sender's local frame,
    one slab width off."""
    py = spec.py
    idx = jnp.arange(spec.nx + 2) * py
    m_lo = planes["mask"][idx]
    m_hi = planes["mask"][idx + spec.ny + 1]
    y = planes["y"]
    y = y.at[idx].add(jnp.where(m_lo > 0, -slab_w_y, 0.0))
    y = y.at[idx + spec.ny + 1].add(jnp.where(m_hi > 0, slab_w_y, 0.0))
    planes["y"] = y
    return planes


def _exchange_2d(planes: dict, spec: DenseCellSpec, names,
                 slab_w_x: float, slab_w_y: float):
    """y-then-x ghost fill + local-frame shifts (corners ride phase 2)."""
    for nme in names:
        planes[nme] = _exchange_ghost_rows_y(planes[nme], spec)
    planes = _shift_ghost_y(planes, spec, slab_w_y)
    for nme in names:
        planes[nme] = _exchange_ghost_columns(planes[nme], spec, axis=AXIS_X)
    planes = _shift_ghost_x(planes, spec, slab_w_x)
    return planes


def _exchange_plane_2d(plane, spec: DenseCellSpec):
    """Scalar plane (rho/pressure): ghost fill without coordinate shifts."""
    plane = _exchange_ghost_rows_y(plane, spec)
    return _exchange_ghost_columns(plane, spec, axis=AXIS_X)


# ---------------------------------------------------------------------------
# the 2-D sharded WCSPH step
# ---------------------------------------------------------------------------


def make_dense_halo_wcsph_step_2d(mesh, spec: DenseSlab2DSpec,
                                  params: FluidParams):
    """step(slabs) -> (slabs, max_vel, n_live, cell_overflow, per_slab_live)
    with per_slab_live of shape (nx_dev, ny_dev)."""
    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)
    d0, gamma, w = params.d0, params.tait_gamma, params.tait_w
    axes = (AXIS_X, AXIS_Y)

    class _ViewX:
        lo, slab_width, migrate_capacity = (
            spec.lo, spec.slab_w_x, spec.migrate_capacity)

    class _ViewY:
        lo, slab_width, migrate_capacity = (
            spec.lo, spec.slab_w_y, spec.migrate_capacity)

    def local_step(pos, vel, press_in, alive, dropped):
        mex = jax.lax.axis_index(AXIS_X).astype(jnp.float32)
        mey = jax.lax.axis_index(AXIS_Y).astype(jnp.float32)
        x0 = spec.lo + spec.slab_w_x * mex
        y0 = spec.lo + spec.slab_w_y * mey

        local = pos - jnp.stack([x0, y0, 0.0])
        live = alive > 0
        park = jnp.asarray([0.5 * spec.slab_w_x, 0.5 * spec.slab_w_y,
                            spec.park_z])
        lpos = jnp.where(live[:, None], local, park)
        flat, valid, _ = dense_indices(lpos, lspec)
        overflow = jnp.sum((~valid) & live)
        valid = valid & live

        planes = build_planes(
            {"x": lpos[:, 0], "y": lpos[:, 1], "z": lpos[:, 2],
             "vx": vel[:, 0], "vy": vel[:, 1], "vz": vel[:, 2]},
            flat, valid, lspec)
        planes = _exchange_2d(planes, lspec,
                              ("x", "y", "z", "vx", "vy", "vz", "mask"),
                              spec.slab_w_x, spec.slab_w_y)

        rho_plane = density_planes(planes, lspec, k, params.mass)
        press_plane = jnp.where(planes["mask"] > 0,
                                tait_eos(rho_plane, d0, params.p0, gamma, w),
                                0.0)
        rho_plane = _exchange_plane_2d(rho_plane, lspec)
        press_plane = _exchange_plane_2d(press_plane, lspec)

        fx, fy, fz = force_planes(planes, rho_plane, press_plane, lspec, k,
                                  params.mass, float(params.mu))
        vals = gather_planes([rho_plane, press_plane, fx, fy, fz], flat)
        rho = jnp.where(valid, vals[:, 0], d0)
        pressure = jnp.where(valid, vals[:, 1], 0.0)
        f = jnp.where(valid[:, None], vals[:, 2:5], 0.0)
        gravity = jnp.asarray(params.gravity, jnp.float32) * params.mass

        state = FluidState(pos=pos, vel=vel, force=gravity + f, density=rho,
                           pressure=pressure)
        state, diag = semi_implicit_euler(state, params)
        state = box_collide(state, (spec.lo,) * 3,
                            (spec.hi_x, spec.hi_y, spec.hi_z))
        new_pos = jnp.where(live[:, None], state.pos, pos)
        new_vel = jnp.where(live[:, None], state.vel, vel)
        press_keep = pressure * alive

        # Two migration passes, one per decomposed dimension.
        new_pos, new_vel, new_press, new_alive, dropped = _migrate(
            new_pos, new_vel, press_keep, alive, dropped, _ViewX,
            axis=AXIS_X, dim=0)
        new_pos, new_vel, new_press, new_alive, dropped = _migrate(
            new_pos, new_vel, new_press, new_alive, dropped, _ViewY,
            axis=AXIS_Y, dim=1)

        max_vel = jax.lax.pmax(jax.lax.stop_gradient(diag.max_vel), axes)
        dropped = jax.lax.psum(dropped, axes)
        live_here = jnp.sum(new_alive)[None, None]     # (1, 1)
        n_live = jax.lax.psum(jnp.sum(new_alive), axes)
        overflow = jax.lax.psum(overflow, axes)
        n_sh = spec.nx_dev * spec.ny_dev
        return (new_pos, new_vel, new_press, new_alive, dropped / n_sh,
                (max_vel, n_live, overflow, live_here))

    sm = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P((AXIS_X, AXIS_Y), None), P((AXIS_X, AXIS_Y), None),
                  P((AXIS_X, AXIS_Y)), P((AXIS_X, AXIS_Y)),
                  P((AXIS_X, AXIS_Y))),
        out_specs=(P((AXIS_X, AXIS_Y), None), P((AXIS_X, AXIS_Y), None),
                   P((AXIS_X, AXIS_Y)), P((AXIS_X, AXIS_Y)),
                   P((AXIS_X, AXIS_Y)),
                   (P(), P(), P(), P(AXIS_X, AXIS_Y))),
    )

    @jax.jit
    def step(slabs: SlabState):
        n_sh = spec.nx_dev * spec.ny_dev
        dropped_sh = jnp.broadcast_to(slabs.dropped / n_sh, (n_sh,))
        press = (slabs.pressure if slabs.pressure is not None
                 else jnp.zeros_like(slabs.alive))
        pos, vel, press, alive, dropped, (max_vel, n_live, ovf, per_slab) = \
            sm(slabs.pos, slabs.vel, press, slabs.alive, dropped_sh)
        out = SlabState(pos=pos, vel=vel, alive=alive,
                        dropped=jnp.sum(dropped), pressure=press)
        return out, max_vel, n_live, ovf, per_slab

    return step


# ---------------------------------------------------------------------------
# the 2-D sharded PCISPH step (flagship solver on the 2-D mesh)
# ---------------------------------------------------------------------------


def make_dense_halo_pcisph_step_2d(mesh, spec: DenseSlab2DSpec,
                                   params: FluidParams, delta: float,
                                   boundary: bool = False,
                                   warm_start: bool = False):
    """Distributed dense PCISPH on the (AXIS_X, AXIS_Y) mesh: per correction
    iteration the predicted-position planes and the pressure/divisor planes
    ride the y-then-x ghost exchange, migration runs one pass per decomposed
    dimension, and the loop exits on the density-error pmax over BOTH axes.
    Boundary stores are passed REPLICATED (every shard holds the full set)
    and each shard bins only the boundary inside its own (x, y) block — the
    ghost exchange delivers neighbor boundary cells, mirroring the 1-D
    path's no-double-counting convention."""
    from dieselfluid_tpu.ops.pallas_sph import (
        pressure_force_pq_planes,
        viscosity_force_planes,
    )
    from dieselfluid_tpu.solvers.pcisph import _Carry

    lspec = spec.local_spec
    k = KernelCoeffs.build(params.h)
    d0 = params.d0
    axes = (AXIS_X, AXIS_Y)

    class _ViewX:
        lo, slab_width, migrate_capacity = (
            spec.lo, spec.slab_w_x, spec.migrate_capacity)

    class _ViewY:
        lo, slab_width, migrate_capacity = (
            spec.lo, spec.slab_w_y, spec.migrate_capacity)

    def local_step(pos, vel, press_in, alive, dropped, *b):
        mex = jax.lax.axis_index(AXIS_X).astype(jnp.float32)
        mey = jax.lax.axis_index(AXIS_Y).astype(jnp.float32)
        x0 = spec.lo + spec.slab_w_x * mex
        y0 = spec.lo + spec.slab_w_y * mey
        off = jnp.stack([x0, y0, 0.0])
        park = jnp.asarray([0.5 * spec.slab_w_x, 0.5 * spec.slab_w_y,
                            spec.park_z])

        live = alive > 0
        lpos = jnp.where(live[:, None], pos - off, park)
        entries, live_all = lpos, live
        if boundary:
            bpos, bmask = b
            own_b = ((bmask > 0)
                     & (bpos[:, 0] >= x0) & (bpos[:, 0] < x0 + spec.slab_w_x)
                     & (bpos[:, 1] >= y0) & (bpos[:, 1] < y0 + spec.slab_w_y))
            lb = jnp.where(own_b[:, None], bpos - off, park)
            entries = jnp.concatenate([lpos, lb], axis=0)
            live_all = jnp.concatenate([live, own_b], axis=0)
        flat, valid, _ = dense_indices(entries, lspec)
        overflow = jnp.sum((~valid) & live_all)
        valid = valid & live_all
        nloc = pos.shape[0]
        flat_f, valid_f = flat[:nloc], valid[:nloc]
        vel_all = (jnp.concatenate([vel, jnp.zeros_like(b[0])], axis=0)
                   if boundary else vel)

        planes = build_planes(
            {"x": entries[:, 0], "y": entries[:, 1], "z": entries[:, 2],
             "vx": vel_all[:, 0], "vy": vel_all[:, 1], "vz": vel_all[:, 2]},
            flat, valid, lspec)
        planes = _exchange_2d(planes, lspec,
                              ("x", "y", "z", "vx", "vy", "vz", "mask"),
                              spec.slab_w_x, spec.slab_w_y)
        mask_x = planes["mask"]               # ghost-filled; frozen per frame

        rho_plane = density_planes(planes, lspec, k, params.mass)
        rho_plane = _exchange_plane_2d(rho_plane, lspec)
        rho = jnp.where(valid_f, gather_planes([rho_plane], flat_f)[:, 0], d0)

        vx_p, vy_p, vz_p = viscosity_force_planes(planes, rho_plane, lspec,
                                                  k, params.mass, params.mu)
        visc = jnp.where(valid_f[:, None],
                         gather_planes([vx_p, vy_p, vz_p], flat_f), 0.0)
        gravity = jnp.asarray(params.gravity, jnp.float32) * params.mass
        ext_force = gravity + visc

        def scatter(values_f, boundary_value=None):
            out = jnp.zeros(lspec.rows * lspec.row_len, jnp.float32).at[
                jnp.where(valid_f, flat_f, 0)
            ].add(jnp.where(valid_f, values_f, 0.0))
            if boundary and boundary_value is not None:
                flat_b, valid_b = flat[nloc:], valid[nloc:]
                out = out.at[jnp.where(valid_b, flat_b, 0)].add(
                    jnp.where(valid_b, boundary_value, 0.0))
            return out.reshape(lspec.plane_shape)

        def body(c: _Carry) -> _Carry:
            accel = (ext_force + c.f_p) / params.mass
            vel_star = vel + accel * params.dt
            pos_star_l = pos - off + vel_star * params.dt
            star_entries = jnp.where((alive > 0)[:, None], pos_star_l, park)
            if boundary:
                star_entries = jnp.concatenate(
                    [star_entries, entries[nloc:]], axis=0)
            p_star = build_planes(
                {"x": star_entries[:, 0], "y": star_entries[:, 1],
                 "z": star_entries[:, 2]}, flat, valid, lspec, mask=mask_x)
            p_star = {n: (_exchange_plane_2d(p_star[n], lspec)
                          if n in ("x", "y", "z") else p_star[n])
                      for n in p_star}
            p_star = _shift_ghost_y(p_star, lspec, spec.slab_w_y)
            p_star = _shift_ghost_x(p_star, lspec, spec.slab_w_x)

            rho_star_plane = density_planes(p_star, lspec, k, params.mass)
            rho_star = jnp.where(
                valid_f, gather_planes([rho_star_plane], flat_f)[:, 0], d0)
            err = (rho_star - d0) * alive
            pressure = jnp.maximum(c.pressure + delta * err, 0.0)

            # Prefolded pq: one scatter + one 2-D ghost exchange per
            # iteration instead of two of each (boundary pq is 0).
            rho_ff = jnp.maximum(rho_star, 0.5 * d0)
            pq_plane = _exchange_plane_2d(
                scatter(pressure / (rho_ff * rho_ff)), lspec)
            fx, fy, fz = pressure_force_pq_planes(planes, pq_plane,
                                                  lspec, k, params.mass)
            f_p = jnp.where(valid_f[:, None],
                            gather_planes([fx, fy, fz], flat_f), 0.0)
            max_ratio = jax.lax.pmax(jnp.max(err) / d0, axes)
            return _Carry(c.it + 1, max_ratio, pressure, f_p)

        def vary(x):
            return jax.lax.pcast(x, axes, to="varying") if any(
                a not in getattr(jax.typeof(x), "vma", axes) for a in axes
            ) else x

        init_press = press_in * alive if warm_start else jnp.zeros_like(alive)
        init = _Carry(it=jnp.int32(0), err=jnp.float32(jnp.inf),
                      pressure=vary(init_press),
                      f_p=vary(jnp.zeros_like(pos)))
        cond = lambda c: (c.it < params.pci_max_iters) & (
            c.err > params.pci_max_density_error_ratio)
        carry = jax.lax.while_loop(cond, body, init)

        state = FluidState(pos=pos, vel=vel, force=ext_force + carry.f_p,
                           density=rho, pressure=carry.pressure)
        state, diag = semi_implicit_euler(state, params)
        state = box_collide(state, (spec.lo,) * 3,
                            (spec.hi_x, spec.hi_y, spec.hi_z))
        new_pos = jnp.where(live[:, None], state.pos, pos)
        new_vel = jnp.where(live[:, None], state.vel, vel)
        press_keep = carry.pressure * alive

        new_pos, new_vel, new_press, new_alive, dropped = _migrate(
            new_pos, new_vel, press_keep, alive, dropped, _ViewX,
            axis=AXIS_X, dim=0)
        new_pos, new_vel, new_press, new_alive, dropped = _migrate(
            new_pos, new_vel, new_press, new_alive, dropped, _ViewY,
            axis=AXIS_Y, dim=1)

        max_vel = jax.lax.pmax(jax.lax.stop_gradient(diag.max_vel), axes)
        dropped = jax.lax.psum(dropped, axes)
        live_here = jnp.sum(new_alive)[None, None]
        n_live = jax.lax.psum(jnp.sum(new_alive), axes)
        overflow = jax.lax.psum(overflow, axes)
        n_sh = spec.nx_dev * spec.ny_dev
        return (new_pos, new_vel, new_press, new_alive, dropped / n_sh,
                (max_vel, n_live, overflow, live_here))

    sharded = P((AXIS_X, AXIS_Y))
    in_specs = [P((AXIS_X, AXIS_Y), None), P((AXIS_X, AXIS_Y), None),
                sharded, sharded, sharded]
    if boundary:
        in_specs += [P(), P()]                # replicated boundary store
    sm = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P((AXIS_X, AXIS_Y), None), P((AXIS_X, AXIS_Y), None),
                   sharded, sharded, sharded,
                   (P(), P(), P(), P(AXIS_X, AXIS_Y))),
    )

    @jax.jit
    def step(slabs: SlabState):
        n_sh = spec.nx_dev * spec.ny_dev
        dropped_sh = jnp.broadcast_to(slabs.dropped / n_sh, (n_sh,))
        press = (slabs.pressure if slabs.pressure is not None
                 else jnp.zeros_like(slabs.alive))
        args = (slabs.pos, slabs.vel, press, slabs.alive, dropped_sh)
        if boundary:
            args += (slabs.boundary_pos, slabs.boundary_mask)
        pos, vel, press, alive, dropped, (max_vel, n_live, ovf, per_slab) = \
            sm(*args)
        out = SlabState(pos=pos, vel=vel, alive=alive,
                        dropped=jnp.sum(dropped), pressure=press,
                        boundary_pos=slabs.boundary_pos,
                        boundary_mask=slabs.boundary_mask)
        return out, max_vel, n_live, ovf, per_slab

    return step


def distribute_2d(state: FluidState, spec: DenseSlab2DSpec) -> SlabState:
    """Host-side: bin a global FluidState into (nx_dev * ny_dev) blocks,
    shard-major order (x-major then y — matches P((AXIS_X, AXIS_Y)))."""
    import numpy as np

    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    press = np.asarray(state.pressure)
    bx = np.clip(((pos[:, 0] - spec.lo) / spec.slab_w_x).astype(int),
                 0, spec.nx_dev - 1)
    by = np.clip(((pos[:, 1] - spec.lo) / spec.slab_w_y).astype(int),
                 0, spec.ny_dev - 1)
    shard = bx * spec.ny_dev + by
    c = spec.capacity
    n_sh = spec.nx_dev * spec.ny_dev
    out_pos = np.zeros((n_sh * c, 3), np.float32)
    out_vel = np.zeros((n_sh * c, 3), np.float32)
    out_press = np.zeros((n_sh * c,), np.float32)
    alive = np.zeros((n_sh * c,), np.float32)
    dropped = 0
    for d in range(n_sh):
        idx = np.where(shard == d)[0]
        take = idx[:c]
        dropped += len(idx) - len(take)
        out_pos[d * c:d * c + len(take)] = pos[take]
        out_vel[d * c:d * c + len(take)] = vel[take]
        out_press[d * c:d * c + len(take)] = press[take]
        alive[d * c:d * c + len(take)] = 1.0
    # Boundary stores ride REPLICATED on the 2-D mesh (each shard bins only
    # its own (x, y) block at runtime — see make_dense_halo_pcisph_step_2d).
    bpos = bmask = None
    if state.boundary_pos is not None:
        bpos = jnp.asarray(state.boundary_pos)
        bmask = jnp.ones((bpos.shape[0],), jnp.float32)
    return SlabState(pos=jnp.asarray(out_pos), vel=jnp.asarray(out_vel),
                     alive=jnp.asarray(alive),
                     dropped=jnp.asarray(float(dropped)),
                     pressure=jnp.asarray(out_press),
                     boundary_pos=bpos, boundary_mask=bmask)
