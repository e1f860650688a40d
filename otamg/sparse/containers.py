"""Capacity-padded sparse containers (layer L0/L1 of the build).

The reference leans on MATLAB's native CSC sparse type and SuiteSparse
kernels (SURVEY.md section 2.4).  Accelerator sparse storage must have
*static shapes*: every container carries a fixed capacity with a validity
count, padding entries point at row/col 0 with value 0 so every kernel can
ignore them arithmetically.

Containers:

* :class:`COO` — coordinate triples, canonical (row-major, col-minor)
  order optional.  The assembly/exchange format.
* :class:`CSR` — row-pointer form, plus an ELL-style padded view
  (``row_cap`` entries per row) used by the ELL SpMV: a gather +
  row-sum over rectangular arrays, not ragged rows.
* :class:`BSR` — block-sparse rows with dense ``(bs, bs)`` blocks; SpMV
  becomes batched small GEMV.

All are pytree-registered, so they pass through ``jit``/``scan``/
``while_loop`` freely.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class COO:
    shape: tuple  # static (nrows, ncols)
    rows: Any     # (cap,) int32
    cols: Any     # (cap,) int32
    vals: Any     # (cap,) dtype; padding entries must be 0 at (0, 0)
    nnz: Any      # () int32 — number of valid leading entries

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals, self.nnz), self.shape

    @classmethod
    def tree_unflatten(cls, shape, leaves):
        return cls(shape, *leaves)

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @classmethod
    def from_dense(cls, A, capacity: int | None = None) -> "COO":
        """Build from a dense matrix.  Under jit the nonzero *pattern* is
        data-dependent, so entries are ranked by |value| > 0 into the
        leading slots (stable row-major order among nonzeros)."""
        nr, nc = A.shape
        r = jnp.repeat(jnp.arange(nr, dtype=jnp.int32), nc)
        c = jnp.tile(jnp.arange(nc, dtype=jnp.int32), nr)
        v = A.reshape(-1)
        nz = v != 0
        nnz = jnp.sum(nz).astype(jnp.int32)
        cap = capacity if capacity is not None else nr * nc
        # stable sort: valid entries first, keeping row-major order
        order = jnp.argsort(jnp.logical_not(nz), stable=True)[:cap]
        keep = jnp.arange(cap) < nnz
        return cls((nr, nc),
                   jnp.where(keep, r[order], 0),
                   jnp.where(keep, c[order], 0),
                   jnp.where(keep, v[order], 0),
                   jnp.minimum(nnz, cap))

    def to_dense(self):
        nr, nc = self.shape
        out = jnp.zeros((nr, nc), self.vals.dtype)
        return out.at[self.rows, self.cols].add(self.vals)

    def matvec(self, x):
        """``y = A @ x`` via gather + segment-sum (padding adds 0 to row 0)."""
        prod = self.vals * x[self.cols]
        return jax.ops.segment_sum(prod, self.rows,
                                   num_segments=self.shape[0])

    def rmatvec(self, y):
        prod = self.vals * y[self.rows]
        return jax.ops.segment_sum(prod, self.cols,
                                   num_segments=self.shape[1])

    def transpose(self) -> "COO":
        """Swap rows/cols and re-canonicalize to row-major order."""
        key = self.cols.astype(jnp.int64) * self.shape[0] + self.rows
        valid = jnp.arange(self.capacity) < self.nnz
        key = jnp.where(valid, key, jnp.iinfo(key.dtype).max)
        order = jnp.argsort(key)
        return COO((self.shape[1], self.shape[0]),
                   jnp.where(valid[order], self.cols[order], 0),
                   jnp.where(valid[order], self.rows[order], 0),
                   jnp.where(valid[order], self.vals[order], 0), self.nnz)

    def sum_duplicates(self) -> "COO":
        """Canonicalize: sort by (row, col) and merge duplicate entries."""
        nr, nc = self.shape
        valid = jnp.arange(self.capacity) < self.nnz
        key = self.rows.astype(jnp.int64) * nc + self.cols
        key = jnp.where(valid, key, jnp.iinfo(key.dtype).max)
        order = jnp.argsort(key)
        k, v = key[order], jnp.where(valid[order], self.vals[order], 0)
        is_new = jnp.concatenate(
            [jnp.ones(1, bool), k[1:] != k[:-1]])
        # only valid entries can start a group
        is_new = jnp.logical_and(is_new, valid[order])
        gid = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        gid = jnp.where(valid[order], gid, self.capacity - 1)
        sums = jax.ops.segment_sum(v, gid, num_segments=self.capacity)
        # representative key of each group
        first_idx = jax.ops.segment_min(
            jnp.arange(self.capacity), gid, num_segments=self.capacity)
        ngroups = jnp.sum(is_new).astype(jnp.int32)
        gvalid = jnp.arange(self.capacity) < ngroups
        safe_first = jnp.minimum(first_idx, self.capacity - 1)
        gkey = jnp.where(gvalid, k[safe_first], 0)
        grows = (gkey // nc).astype(jnp.int32)
        gcols = (gkey % nc).astype(jnp.int32)
        return COO(self.shape,
                   jnp.where(gvalid, grows, 0),
                   jnp.where(gvalid, gcols, 0),
                   jnp.where(gvalid, sums, 0), ngroups)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSR:
    """Row-pointer sparse matrix with an ELL padded view.

    ``ell_cols``/``ell_vals`` have shape ``(nrows, row_cap)``; short rows
    are padded with column 0 / value 0.  The ELL view is what the Pallas
    SpMV kernel consumes (rectangular, tileable); ``indptr`` supports
    host-side interop and conversions.
    """

    shape: tuple
    indptr: Any     # (nrows + 1,) int32
    ell_cols: Any   # (nrows, row_cap) int32
    ell_vals: Any   # (nrows, row_cap)

    def tree_flatten(self):
        return (self.indptr, self.ell_cols, self.ell_vals), self.shape

    @classmethod
    def tree_unflatten(cls, shape, leaves):
        return cls(shape, *leaves)

    @property
    def row_cap(self) -> int:
        return self.ell_cols.shape[1]

    @classmethod
    def from_dense(cls, A, row_cap: int | None = None) -> "CSR":
        nr, nc = A.shape
        cap = row_cap if row_cap is not None else nc
        nz = A != 0
        counts = jnp.sum(nz, axis=1).astype(jnp.int32)
        indptr = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])
        # per row: nonzero columns first (stable), padded with 0
        order = jnp.argsort(jnp.logical_not(nz), axis=1, stable=True)
        order = order[:, :cap]
        keep = jnp.arange(cap)[None, :] < counts[:, None]
        cols = jnp.where(keep, order, 0).astype(jnp.int32)
        vals = jnp.where(keep, jnp.take_along_axis(A, order, axis=1), 0)
        return cls((nr, nc), indptr, cols, vals)

    @classmethod
    def from_coo(cls, coo: COO, row_cap: int) -> "CSR":
        c = coo.sum_duplicates()
        nr, nc = c.shape
        valid = jnp.arange(c.capacity) < c.nnz
        counts = jax.ops.segment_sum(valid.astype(jnp.int32),
                                     c.rows, num_segments=nr)
        indptr = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])
        # position within row = global index - row start (entries sorted)
        pos = jnp.arange(c.capacity, dtype=jnp.int32) - indptr[c.rows]
        inbound = jnp.logical_and(valid, pos < row_cap)
        safe_pos = jnp.where(inbound, pos, 0)
        safe_row = jnp.where(inbound, c.rows, 0)
        cols = jnp.zeros((nr, row_cap), jnp.int32)
        vals = jnp.zeros((nr, row_cap), c.vals.dtype)
        cols = cols.at[safe_row, safe_pos].set(
            jnp.where(inbound, c.cols, 0).astype(jnp.int32))
        vals = vals.at[safe_row, safe_pos].add(
            jnp.where(inbound, c.vals, 0))
        return cls((nr, nc), indptr, cols, vals)

    def to_dense(self):
        nr, nc = self.shape
        out = jnp.zeros((nr, nc), self.ell_vals.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(nr, dtype=jnp.int32)[:, None], self.ell_cols.shape)
        return out.at[rows, self.ell_cols].add(self.ell_vals)

    def matvec(self, x):
        """ELL SpMV: gather + row reduction (XLA path; the Pallas kernel
        lives in :mod:`otamg.sparse.kernels`)."""
        return jnp.sum(self.ell_vals * x[self.ell_cols], axis=1)

    def diag(self):
        n = min(self.shape)
        hit = self.ell_cols[:n] == jnp.arange(n, dtype=jnp.int32)[:, None]
        return jnp.sum(jnp.where(hit, self.ell_vals[:n], 0), axis=1)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse rows: ``blocks[i, k]`` is the dense ``(bs, bs)`` block
    in block-row ``i`` at block-column ``block_cols[i, k]``; padded block
    slots use block-column 0 with an all-zero block.  SpMV is a batched
    GEMV."""

    shape: tuple        # static (nrows, ncols), multiples of bs
    block_cols: Any     # (nbr, blk_cap) int32
    blocks: Any         # (nbr, blk_cap, bs, bs)

    def tree_flatten(self):
        return (self.block_cols, self.blocks), self.shape

    @classmethod
    def tree_unflatten(cls, shape, leaves):
        return cls(shape, *leaves)

    @property
    def bs(self) -> int:
        return self.blocks.shape[-1]

    @classmethod
    def from_dense(cls, A, bs: int, blk_cap: int | None = None) -> "BSR":
        nr, nc = A.shape
        assert nr % bs == 0 and nc % bs == 0
        nbr, nbc = nr // bs, nc // bs
        Ab = A.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
        nzb = jnp.any(Ab != 0, axis=(2, 3))
        cap = blk_cap if blk_cap is not None else nbc
        counts = jnp.sum(nzb, axis=1).astype(jnp.int32)
        order = jnp.argsort(jnp.logical_not(nzb), axis=1, stable=True)
        order = order[:, :cap]
        keep = jnp.arange(cap)[None, :] < counts[:, None]
        bcols = jnp.where(keep, order, 0).astype(jnp.int32)
        blocks = jnp.take_along_axis(Ab, order[:, :, None, None], axis=1)
        blocks = jnp.where(keep[:, :, None, None], blocks, 0)
        return cls((nr, nc), bcols, blocks)

    def to_dense(self):
        nr, nc = self.shape
        bs = self.bs
        nbr, nbc = nr // bs, nc // bs
        out = jnp.zeros((nbr, nbc, bs, bs), self.blocks.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(nbr, dtype=jnp.int32)[:, None],
            self.block_cols.shape)
        out = out.at[rows, self.block_cols].add(self.blocks)
        return out.transpose(0, 2, 1, 3).reshape(nr, nc)

    def matvec(self, x):
        bs = self.bs
        nbc = self.shape[1] // bs
        xb = x.reshape(nbc, bs)
        gathered = xb[self.block_cols]              # (nbr, cap, bs)
        prod = jnp.einsum("rkij,rkj->ri", self.blocks, gathered,
                          precision=jax.lax.Precision.HIGHEST)
        return prod.reshape(self.shape[0])


def spgemm(A: COO, B: CSR, out_capacity: int) -> COO:
    """Sparse general matrix-matrix product ``C = A @ B`` by
    expansion-sort-compress (the static-shape analogue of the SpGEMM MATLAB
    performs inside ``transfer.m:66``'s Galerkin triple product):

    every valid A-entry ``(i, k, v)`` expands against row ``k`` of B's ELL
    view (bounded fan-out ``row_cap``), the ``nnzA * row_cap`` products are
    then canonicalized by :meth:`COO.sum_duplicates`.  All shapes static.
    """
    cap_a = A.capacity
    R = B.row_cap
    # A product slot is valid only when BOTH the A entry and the B ELL
    # slot are real — padded B slots (beyond the row's count) would
    # otherwise create spurious zero-valued groups at (i, 0) that displace
    # real trailing entries under a tight out_capacity.
    a_valid = (jnp.arange(cap_a) < A.nnz)[:, None]
    b_counts = B.indptr[1:] - B.indptr[:-1]
    b_valid = (jnp.arange(R)[None, :]
               < b_counts[A.cols][:, None])
    valid = jnp.logical_and(a_valid, b_valid)
    bcols = B.ell_cols[A.cols]                  # (capA, R)
    bvals = B.ell_vals[A.cols]
    rows = jnp.broadcast_to(A.rows[:, None], (cap_a, R))
    vals = jnp.where(valid, A.vals[:, None] * bvals, 0)
    rows = jnp.where(valid, rows, 0)
    cols = jnp.where(valid, bcols, 0)
    # pack valid products to the front so the COO nnz bound is exact
    flat_valid = valid.reshape(-1)
    order = jnp.argsort(jnp.logical_not(flat_valid), stable=True)
    nvalid = jnp.sum(flat_valid).astype(jnp.int32)
    expanded = COO((A.shape[0], B.shape[1]),
                   rows.reshape(-1)[order], cols.reshape(-1)[order],
                   vals.reshape(-1)[order], nvalid)
    merged = expanded.sum_duplicates()
    # shrink to the requested capacity (entries are canonically ordered)
    return COO(merged.shape, merged.rows[:out_capacity],
               merged.cols[:out_capacity], merged.vals[:out_capacity],
               jnp.minimum(merged.nnz, out_capacity))
