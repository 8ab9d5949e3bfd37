"""Brute-force O(N^2) neighbor search — the exact oracle.

Replaces the reference's LSH sampler for small systems and serves as the
correctness oracle for the cell-grid provider (the reference's LSH probe,
ref: sampler/lsh/lsh.go:136-181, returns *approximate* bucket-mates, not true
spatial neighbors; this provider returns the true radius neighborhood the SPH
operators mathematically want).

The (N, M) pairwise distance matrix is computed in expanded form so the inner
product rides the MXU; fine up to tens of thousands of particles, beyond that
use the cell grid.
"""

from __future__ import annotations

import jax.lax
import jax.numpy as jnp

from dieselfluid_tpu.neighbors.types import Neighborhood


def pairwise_distances(query: jnp.ndarray, source: jnp.ndarray) -> jnp.ndarray:
    """(N, M) Euclidean distances from direct (N, M, 3) differences.

    The expanded |q|^2+|s|^2-2q.s form would ride the matrix units, but a
    reduced-precision default matmul (bf16/TF32) plus catastrophic
    cancellation costs ~1e-1 absolute error near r ~ h — unacceptable for an
    oracle. Direct differences are exact f32; this provider is for modest N anyway (the cell grid
    covers large N).
    """
    d2 = jnp.zeros((query.shape[0], source.shape[0]), jnp.float32)
    for c in range(3):
        diff = query[:, c][:, None] - source[:, c][None, :]
        d2 = d2 + diff * diff
    return jnp.sqrt(d2)


def brute_force_neighborhood(
    query: jnp.ndarray,
    source: jnp.ndarray,
    h: float,
    k: int,
    exclude_self: bool = True,
    self_offset=None,
) -> Neighborhood:
    """True k-capped radius neighborhood via full pairwise distances.

    Slots hold the k nearest in-radius source particles; the mask zeroes slots
    beyond the in-radius count. With k >= the max true neighbor count this is
    exact (the oracle the cell grid is tested against).

    When `query` is a contiguous shard of `source` (SPMD: local particles vs
    the all-gathered pool), pass `self_offset` = the global row index of
    query[0]; self-pairs (i, self_offset + i) are then excluded.
    """
    n, m = query.shape[0], source.shape[0]
    d = pairwise_distances(query, source)
    in_radius = d < h
    if self_offset is not None:
        rows = jnp.arange(n)[:, None]
        cols = jnp.arange(m)[None, :]
        in_radius = in_radius & (cols != rows + self_offset)
    elif exclude_self and query.shape == source.shape:
        in_radius = in_radius & ~jnp.eye(n, m, dtype=bool)
    ranked = jnp.where(in_radius, d, jnp.inf)
    neg_vals, idx = jax.lax.top_k(-ranked, k)       # k smallest distances
    valid = jnp.isfinite(neg_vals)
    mask = valid.astype(jnp.float32)
    idx = jnp.where(valid, idx, 0)
    return Neighborhood(idx=idx.astype(jnp.int32), mask=mask)
