"""Dense cell-grid layout for the SPH stencil sweeps.

Particles are binned into a dense (padded) cell lattice stored as 3D f32
planes of shape (rows, sub, 128):

  * rows = (x, y) cell columns incl. one ghost ring: row = (i+1)*py + (j+1);
  * the z axis (cells * capacity slots) lives in the flattened trailing
    (sub, 128) dims, padded so capacity * z_block == 128 flat slots per
    128-slot chunk and ghosted by one z_block on each side.

Why this shape: every cell's 3x3x3 neighbourhood is nine contiguous slot
windows (one per neighbouring (x, y) column, spanning the z cells below and
above), so a sweep reads its candidates with plain strided loads — no
sorts, no global gathers on the hot path. This replaces the reference's LSH
table upload (ref: sampler/lsh/lsh.go GetData1D + pcisph.h get_sample's
fixed fetch loop).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class DenseCellSpec:
    """Static dense-layout config. Cell edge must be >= the kernel radius."""

    nx: int
    ny: int
    nz: int
    capacity: int
    cell: float
    lo: Tuple[float, float, float] = (-1.0, -1.0, -1.0)

    def __post_init__(self):
        assert 128 % self.capacity == 0, "capacity must divide 128"

    @staticmethod
    def for_domain(lo, hi, h: float, capacity: int = 16) -> "DenseCellSpec":
        lo_a = np.asarray(lo, np.float64)
        hi_a = np.asarray(hi, np.float64)
        dims = np.maximum(np.ceil((hi_a - lo_a) / h), 1).astype(int)
        return DenseCellSpec(nx=int(dims[0]), ny=int(dims[1]), nz=int(dims[2]),
                             capacity=capacity, cell=float(h), lo=tuple(lo))

    @property
    def z_block(self) -> int:
        """z cells per 128-slot chunk (capacity * z_block == 128)."""
        return 128 // self.capacity

    @property
    def nz_padded(self) -> int:
        zb = self.z_block
        return ((self.nz + zb - 1) // zb) * zb

    @property
    def px(self) -> int:
        return self.nx + 2

    @property
    def py(self) -> int:
        return self.ny + 2

    @property
    def rows(self) -> int:
        return self.px * self.py

    @property
    def sub(self) -> int:
        """128-slot chunks per (x,y) column: interior z blocks + one ghost
        each side."""
        return self.nz_padded // self.z_block + 2

    @property
    def row_len(self) -> int:
        return self.sub * 128

    @property
    def plane_shape(self) -> Tuple[int, int, int]:
        return (self.rows, self.sub, 128)


def dense_indices(pos: jnp.ndarray, spec: DenseCellSpec):
    """Per-particle dense slot: (flat_index, valid_mask, overflow_count).

    flat indexes the flattened (rows * sub * 128) plane. Slot ranks come from
    one argsort over cell ids; particles beyond a cell's capacity are dropped
    from the structure and counted.
    """
    c = spec.capacity
    lo = jnp.asarray(spec.lo, jnp.float32)
    ijk = jnp.floor((pos - lo) / spec.cell).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, jnp.asarray([spec.nx - 1, spec.ny - 1, spec.nz - 1]))
    cid = (ijk[:, 0] * spec.ny + ijk[:, 1]) * spec.nz + ijk[:, 2]

    order = jnp.argsort(cid)
    sorted_cid = cid[order]
    # Within-cell rank = index − first index of this cell in the sorted
    # array. First-occurrence indices come from a segmented running max over
    # segment-start positions — O(N) elementwise + one cummax, instead of a
    # binary search per cell (searchsorted over ncells was the dominant cost
    # of this function at 1M particles/cells).
    idx = jnp.arange(pos.shape[0], dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]])
    first_occ = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank_sorted = idx - first_occ
    rank = jnp.zeros_like(rank_sorted).at[order].set(rank_sorted)

    valid = rank < c
    overflow = jnp.sum(~valid)

    row = (ijk[:, 0] + 1) * spec.py + (ijk[:, 1] + 1)
    col = (ijk[:, 2] + spec.z_block) * c + jnp.minimum(rank, c - 1)
    flat = row * spec.row_len + col
    return flat, valid, overflow


def build_planes(values: Dict[str, jnp.ndarray], flat, valid,
                 spec: DenseCellSpec,
                 mask: jnp.ndarray = None) -> Dict[str, jnp.ndarray]:
    """Scatter per-particle channels into dense planes (+ a 'mask' plane).

    One scatter per channel (a single (N, C) payload scatter + transpose
    was tried on an earlier accelerator and lost: the channel-minor
    transpose cost more than the extra scatter passes).

    Slots are unique by construction (dense_indices assigns one slot per
    valid particle; invalid particles park in DISTINCT trash slots past the
    plane), so every scatter runs in `unique_indices` mode — XLA skips the
    duplicate-combining path.

    `mask`: a frozen mask plane from a previous build over the SAME
    binning (PCISPH rebuilds value planes per correction iteration while
    the binning — and therefore the mask — is frozen for the frame);
    passing it skips the mask scatter."""
    size = spec.rows * spec.row_len
    n = flat.shape[0]
    idx = jnp.arange(n, dtype=flat.dtype)
    safe = jnp.where(valid, flat, size + idx)
    out = {}
    if mask is None:
        ones = jnp.where(valid, 1.0, 0.0)
        m = jnp.zeros((size + n,), jnp.float32).at[safe].set(
            ones, unique_indices=True)
        out["mask"] = m[:size].reshape(spec.plane_shape)
    else:
        out["mask"] = mask
    for name, v in values.items():
        plane = jnp.zeros((size + n,), jnp.float32).at[safe].set(
            v, unique_indices=True)
        out[name] = plane[:size].reshape(spec.plane_shape)
    return out


def slot_particle_map(flat, valid, spec: DenseCellSpec) -> jnp.ndarray:
    """Inverse binning: per-SLOT particle index (int32; -1 = empty slot).

    Slot 0 is a ghost-ring slot (rows index from the +1 ghost ring), so the
    scatter-max of invalid particles parked at slot 0 can never shadow a
    real particle.

    NOTE: building planes by GATHERING through this map (16M slot-indexed
    loads from a 1M-element source) measured far slower than the scatter
    build on an earlier accelerator, and has not been measured on the GPU.
    Kept for diagnostics/tests only; every production build uses
    `build_planes`.
    """
    size = spec.rows * spec.row_len
    safe = jnp.where(valid, flat, 0)
    idx = jnp.arange(flat.shape[0], dtype=jnp.int32)
    return jnp.full((size,), -1, jnp.int32).at[safe].max(
        jnp.where(valid, idx, -1))


def build_planes_from_map(values: Dict[str, jnp.ndarray], smap: jnp.ndarray,
                          spec: DenseCellSpec) -> Dict[str, jnp.ndarray]:
    """Dense planes (+ 'mask') from per-particle channels via the slot map.

    Equivalent to `build_planes` (tested) but gather-based. See the
    slot_particle_map NOTE — do not use on the hot path."""
    occupied = smap >= 0
    src = jnp.where(occupied, smap, 0)
    out = {"mask": occupied.astype(jnp.float32).reshape(spec.plane_shape)}
    for name, v in values.items():
        out[name] = jnp.where(occupied, v[src], 0.0).reshape(spec.plane_shape)
    return out


def gather_plane(plane: jnp.ndarray, flat: jnp.ndarray) -> jnp.ndarray:
    """Read per-particle values back out of a dense plane."""
    return plane.reshape(-1)[flat]


def gather_planes(planes, flat: jnp.ndarray) -> jnp.ndarray:
    """Per-particle values from C planes as one (N, C) gather.

    Stacks the planes channel-minor first so the random access pays one
    index lookup for all channels (same trick as build_planes, inverted)."""
    stacked = jnp.stack([p.reshape(-1) for p in planes], axis=-1)
    return stacked[flat]
