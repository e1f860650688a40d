"""Distributed row-partitioned SpMV with explicit collectives.

Two shard_map-based schemes for ``y = A x`` with ``A`` row-block sharded
over a 1-D mesh axis (the framework's plan/KKT row partition):

* :func:`spmv_allgather` — gather the full input vector, local ELL SpMV.
  Right when ``x`` is small relative to the matrix (this framework's KKT
  vectors) or the sparsity is unstructured: one ``all_gather`` over the
  interconnect, local compute at full bandwidth.
* :func:`spmv_halo` — for *banded* row partitions (each shard's column
  support fits its own rows plus a ``halo`` margin): exchange only the
  halo slices with neighbor shards via ``ppermute`` (bidirectional ring),
  and compute the interior rows while the halo transfer is in flight —
  XLA schedules the ppermute asynchronously, so interior compute overlaps
  communication.  This is the classic distributed-SpMV pattern the
  north-star asks for ("halo vector exchange via collectives overlapped
  with compute") for grid-structured operators.

Correctness of both is pinned against the single-device ELL SpMV in
``tests/test_dist.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from otamg.sparse.kernels import ell_spmv


def spmv_allgather(mesh: Mesh, ell_cols, ell_vals, x,
                   axis_name: str = "x"):
    """Row-partitioned SpMV; input vector assembled by ``all_gather``."""

    def local(cols, vals, xs):
        xfull = lax.all_gather(xs, axis_name, tiled=True)
        return ell_spmv(cols, vals, xfull)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None), P(axis_name)),
        out_specs=P(axis_name))(ell_cols, ell_vals, x)


def spmv_halo(mesh: Mesh, ell_cols, ell_vals, x, halo: int,
              axis_name: str = "x"):
    """Banded row-partitioned SpMV with bidirectional halo exchange.

    Requires: with ``R`` rows per shard, every column index in shard ``s``
    lies in ``[s*R - halo, (s+1)*R + halo)`` and ``halo <= R``.  Column
    indices are global; each shard rebases them into its extended local
    window ``[0, R + 2*halo)``.
    """
    ndev = mesh.devices.size
    nrows = ell_cols.shape[0]
    assert nrows % ndev == 0, "rows must divide evenly over the mesh"
    R = nrows // ndev
    assert halo <= R, "halo wider than a shard's row block"

    def local(cols, vals, xs):
        idx = lax.axis_index(axis_name)
        # Bidirectional ring: send my top slice to the left neighbor's
        # bottom halo and my bottom slice to the right neighbor's top halo.
        right = [(i, (i + 1) % ndev) for i in range(ndev)]
        left = [(i, (i - 1) % ndev) for i in range(ndev)]
        from_left = lax.ppermute(xs[-halo:], axis_name, right)
        from_right = lax.ppermute(xs[:halo], axis_name, left)
        # Rebase global columns into the extended window.  Edge shards
        # receive wrapped (invalid) halos; banded matrices never index
        # them, the clamp only guards the gather.
        base = idx * R - halo
        lcols = jnp.clip(cols - base, 0, R + 2 * halo - 1)
        # Overlap BY CONSTRUCTION: split the row sums into an interior
        # term that reads only local data (no collective in its dependency
        # cone — schedulable while the ppermute is in flight, as XLA
        # compiles collectives to async start/done pairs) plus a small
        # halo-correction term that alone depends on the exchange.  The
        # split is exact: the two gathered vectors are disjointly nonzero.
        zeros_h = jnp.zeros(halo, xs.dtype)
        x_interior = jnp.concatenate([zeros_h, xs, zeros_h])
        x_halo = jnp.concatenate(
            [from_left, jnp.zeros(R, xs.dtype), from_right])
        y = jnp.sum(vals * x_interior[lcols], axis=1)
        return y + jnp.sum(vals * x_halo[lcols], axis=1)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None), P(axis_name)),
        out_specs=P(axis_name))(ell_cols, ell_vals, x)
