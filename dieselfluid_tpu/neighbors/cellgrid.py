"""Sorted cell-grid neighbor search — the scalable array-program sampler.

Replaces the reference's LSH bucket sampler (ref: sampler/lsh/lsh.go — random
hyperplane signs -> 255 buckets -> forward-scan 100 samples), which returns
*approximate* bucket-mates, with the principled spatial structure SURVEY.md §5
prescribes: hash particles to cells of edge ~h, argsort by cell id, probe the
27-cell stencil, and compact to a fixed-degree Neighborhood by distance.

All shapes are static: cell capacity C and neighbor degree K are config; a
cell holding more than C particles drops the overflow (use
`overflow_fraction` to size C — no silent caps without a measurement hook).

This is also the component that shards: each device owns a slab of cells and
halo-exchanges boundary cells over ICI (parallel/halo.py builds on this).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dieselfluid_tpu.neighbors.types import Neighborhood


@dataclasses.dataclass(frozen=True)
class CellGridSpec:
    """Static cell-grid configuration.

    lo/hi: domain bounds; cell: cell edge length (>= kernel radius h so the
    27-stencil covers the support); capacity: max particles per cell.
    """

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    cell: float
    capacity: int = 16

    @property
    def dims(self) -> Tuple[int, int, int]:
        lo = np.asarray(self.lo, np.float64)
        hi = np.asarray(self.hi, np.float64)
        return tuple(int(x) for x in np.maximum(np.ceil((hi - lo) / self.cell), 1))

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @staticmethod
    def for_domain(lo, hi, h: float, capacity: int = 16) -> "CellGridSpec":
        return CellGridSpec(lo=tuple(lo), hi=tuple(hi), cell=float(h), capacity=capacity)


def cell_coords(pos: jnp.ndarray, spec: CellGridSpec) -> jnp.ndarray:
    """(N, 3) int32 cell coordinates, clipped into the grid."""
    lo = jnp.asarray(spec.lo, jnp.float32)
    ijk = jnp.floor((pos - lo) / spec.cell).astype(jnp.int32)
    return jnp.clip(ijk, 0, jnp.asarray(spec.dims, jnp.int32) - 1)


def cell_id(pos: jnp.ndarray, spec: CellGridSpec) -> jnp.ndarray:
    """(N,) int32 linearized cell ids (x-major, z fastest — matches Grid.Index)."""
    nx, ny, nz = spec.dims
    ijk = cell_coords(pos, spec)
    return (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]


def build_cell_table(pos: jnp.ndarray, spec: CellGridSpec):
    """Sort particles by cell: returns (order, starts, cid_sorted).

    order:  (N,) permutation — particle indices sorted by cell id.
    starts: (num_cells+1,) prefix offsets into `order` per cell.
    """
    cid = cell_id(pos, spec)
    order = jnp.argsort(cid)
    sorted_cid = cid[order]
    starts = jnp.searchsorted(
        sorted_cid, jnp.arange(spec.num_cells + 1, dtype=sorted_cid.dtype)
    ).astype(jnp.int32)
    return order, starts


def overflow_fraction(pos: jnp.ndarray, spec: CellGridSpec) -> jnp.ndarray:
    """Fraction of particles beyond `capacity` in their cell (should be ~0)."""
    _, starts = build_cell_table(pos, spec)
    counts = starts[1:] - starts[:-1]
    dropped = jnp.sum(jnp.maximum(counts - spec.capacity, 0))
    return dropped / pos.shape[0]


def _stencil_cells(ijk: jnp.ndarray, spec: CellGridSpec):
    """(N, 27) linear ids of the 3x3x3 stencil, with validity for OOB cells."""
    nx, ny, nz = spec.dims
    offsets = jnp.asarray(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        jnp.int32,
    )                                               # (27, 3)
    nbr = ijk[:, None, :] + offsets[None, :, :]     # (N, 27, 3)
    valid = jnp.all((nbr >= 0) & (nbr < jnp.asarray(spec.dims, jnp.int32)), axis=-1)
    nbr = jnp.clip(nbr, 0, jnp.asarray(spec.dims, jnp.int32) - 1)
    lin = (nbr[..., 0] * ny + nbr[..., 1]) * nz + nbr[..., 2]
    return lin, valid


def cell_grid_neighborhood(
    query: jnp.ndarray,
    source: jnp.ndarray,
    h: float,
    k: int,
    spec: CellGridSpec,
    exclude_self: bool = True,
    self_offset=None,
) -> Neighborhood:
    """Fixed-degree radius neighborhood via the 27-cell stencil.

    Exact (vs brute force) whenever no cell overflows `spec.capacity` and no
    true neighborhood exceeds k. `self_offset` as in brute_force_neighborhood
    for SPMD query shards; `exclude_self=True` with query==source removes the
    identity pair by index.
    """
    n = query.shape[0]
    c = spec.capacity
    order, starts = build_cell_table(source, spec)

    ijk_q = cell_coords(query, spec)
    cells, cell_valid = _stencil_cells(ijk_q, spec)              # (N, 27)
    start = starts[cells]                                        # (N, 27)
    end = starts[cells + 1]

    slot = jnp.arange(c, dtype=jnp.int32)                        # (C,)
    cand_rank = start[..., None] + slot                          # (N, 27, C)
    cand_valid = (cand_rank < end[..., None]) & cell_valid[..., None]
    cand_rank = jnp.minimum(cand_rank, source.shape[0] - 1)
    cand_idx = order[cand_rank]                                  # (N, 27, C)

    cand_idx = cand_idx.reshape(n, 27 * c)
    cand_valid = cand_valid.reshape(n, 27 * c)

    # Component-wise distance: no (N, 27C, 3) intermediate — a trailing dim
    # of 3 can pad to a wide minor tile (up to 42x memory at scale).
    dx = source[:, 0][cand_idx] - query[:, 0:1]
    dy = source[:, 1][cand_idx] - query[:, 1:2]
    dz = source[:, 2][cand_idx] - query[:, 2:3]
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    in_radius = cand_valid & (dist < h)
    if self_offset is not None:
        rows = jnp.arange(n, dtype=cand_idx.dtype)[:, None]
        in_radius = in_radius & (cand_idx != rows + self_offset)
    elif exclude_self and query.shape == source.shape:
        rows = jnp.arange(n, dtype=cand_idx.dtype)[:, None]
        in_radius = in_radius & (cand_idx != rows)

    ranked = jnp.where(in_radius, dist, jnp.inf)
    # A 27-cell stencil yields at most 27*C candidates; clamp k and pad the
    # result back to the requested degree with masked slots.
    k_eff = min(k, 27 * c)
    neg_vals, slot_idx = jax.lax.top_k(-ranked, k_eff)
    valid = jnp.isfinite(neg_vals)
    idx = jnp.take_along_axis(cand_idx, slot_idx, axis=1)
    idx = jnp.where(valid, idx, 0)
    if k_eff < k:
        pad = ((0, 0), (0, k - k_eff))
        idx = jnp.pad(idx, pad)
        valid = jnp.pad(valid, pad)
    return Neighborhood(idx=idx.astype(jnp.int32), mask=valid.astype(jnp.float32))
