"""Random-hyperplane LSH sampler — reference-parity neighbor provider.

ref: sampler/lsh/lsh.go — 8 random hyperplane vectors give an 8-bit sign
hash mod `buckets`; per-particle samples are the first SAMPLES(=100) entries
scanning forward from the particle's own bucket. This is an *approximate*
sampler (bucket-mates share a random projection cone, not spatial
proximity) kept for behavioral parity and for the GPU-export surfaces
(GetData1D / GetVectors, ref: lsh.go:70-90) the reference uploads to OpenCL.
The production sampler is neighbors.cellgrid.

Vectorized design: instead of Go's map-of-slices + per-particle scan loops,
particles are argsorted by bucket id; "scan forward from my bucket" becomes a
cyclic window over the sorted order — identical sample multisets, one gather.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from dieselfluid_tpu.neighbors.types import Neighborhood

LOAD_FACTOR = 1.5     # ref: lsh.go:14
SAMPLES = 100         # ref: lsh.go:17


@dataclasses.dataclass(frozen=True)
class LSHSpec:
    """Static sampler config. ref: lsh.go Allocate:30-52."""

    buckets: int = 255
    hash_bits: int = 8
    samples: int = SAMPLES

    def bucket_size(self, num_particles: int) -> int:
        """ref: lsh.go:34 — load-factor-scaled table row length."""
        return int((num_particles / self.buckets) * LOAD_FACTOR)


def hash_vectors(key: jax.Array, spec: LSHSpec) -> jnp.ndarray:
    """(hash_bits, 3) random hyperplanes in [-0.5, 0.5]. ref: lsh.go:40-43."""
    return jax.random.uniform(key, (spec.hash_bits, 3), jnp.float32) - 0.5


def lsh_hash(pos: jnp.ndarray, vectors: jnp.ndarray, buckets: int) -> jnp.ndarray:
    """Sign-bit hash mod buckets. ref: lsh.go Hash:102-111 —
    hash = ((hash << 1) + (dot > 0)) % buckets, sgn(x<=0)=0."""
    dots = jnp.einsum("nd,hd->nh", pos, vectors, precision=jax.lax.Precision.HIGHEST)
    bits = (dots > 0).astype(jnp.int32)
    weights = 2 ** jnp.arange(vectors.shape[0] - 1, -1, -1, dtype=jnp.int32)
    return jnp.sum(bits * weights, axis=-1) % buckets


def build_table(pos: jnp.ndarray, vectors: jnp.ndarray, spec: LSHSpec):
    """(order, starts, hashes): particles sorted by bucket + prefix offsets.

    The moral equivalent of UpdateSampler's full rehash (ref: lsh.go:126-133).
    """
    h = lsh_hash(pos, vectors, spec.buckets)
    order = jnp.argsort(h)
    sorted_h = h[order]
    starts = jnp.searchsorted(sorted_h, jnp.arange(spec.buckets + 1, dtype=sorted_h.dtype))
    return order, starts.astype(jnp.int32), h


def get_samples(pos: jnp.ndarray, vectors: jnp.ndarray, spec: LSHSpec,
                query_pos=None) -> Neighborhood:
    """Per-query sample lists: first `samples` particles scanning forward from
    the query's bucket (cyclic). ref: lsh.go GetSamples:136-158 /
    GetSamplesFromPosition:160-181. All slots valid (mask of ones), matching
    the reference's fixed-size sample arrays.
    """
    q = pos if query_pos is None else query_pos
    order, starts, _ = build_table(pos, vectors, spec)
    qh = lsh_hash(q, vectors, spec.buckets)
    start = starts[qh]                                  # (N,)
    n = pos.shape[0]
    window = (start[:, None] + jnp.arange(spec.samples, dtype=jnp.int32)) % n
    idx = order[window]
    return Neighborhood(idx=idx.astype(jnp.int32),
                        mask=jnp.ones(idx.shape, jnp.float32))


def get_data_1d(pos: jnp.ndarray, vectors: jnp.ndarray, spec: LSHSpec) -> jnp.ndarray:
    """Flattened (buckets * bucket_size,) table for device upload.

    ref: lsh.go GetData1D:70-80 — row-major bucket table, zero-padded.
    """
    n = pos.shape[0]
    size = max(spec.bucket_size(n), 1)
    order, starts, _ = build_table(pos, vectors, spec)
    slot = jnp.arange(size, dtype=jnp.int32)
    rank = starts[:-1, None] + slot[None, :]            # (buckets, size)
    valid = rank < starts[1:, None]
    rank = jnp.minimum(rank, n - 1)
    table = jnp.where(valid, order[rank], 0)
    return table.reshape(-1)


def get_vectors(vectors: jnp.ndarray) -> jnp.ndarray:
    """Flattened (hash_bits*3,) hyperplane export. ref: lsh.go GetVectors:82-90."""
    return vectors.reshape(-1)
