"""Sparse assembly of the OT KKT block ``H0 = A diag(s) A^T``
(reference ``ASAt.m``) into padded containers.

The structured solver path never materializes ``H0`` (it works on the
``(m, n)`` mask directly); this module provides the *assembled* form for
the general sparse pipeline — the "diagonal-scaled SpGEMM for KKT
assembly" capability: the nonzero pattern of the off-diagonal blocks is
exactly the active-set mask, so assembly is a masked scatter, not a
general SpGEMM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from otamg.sparse.containers import COO

_P = lax.Precision.HIGHEST


def asat_coo(S: jax.Array, p: jax.Array, q: jax.Array,
             capacity: int | None = None) -> COO:
    """Assemble ``H0`` as an ``(n+m) x (n+m)`` padded COO.

    Layout matches ``ASAt.m:14-19``: node order [n-block; m-block],
    ``H0 = [[diag(Y^T p^2), diag(q) Y^T diag(p)],
            [diag(p) Y diag(q), diag(Y q^2)]]``.
    Capacity defaults to ``2 m n + n + m`` (dense mask worst case); pass a
    tighter bound when the active set is known to be sparser.
    """
    m, n = S.shape
    N = n + m
    if capacity is None:
        capacity = 2 * m * n + N
    d1 = jnp.matmul(S.T, p * p, precision=_P)
    d2 = jnp.matmul(S, q * q, precision=_P)
    # off-diagonal entries: value q_j p_i s_ij at (j, n+i) and (n+i, j)
    vals_off = (q[None, :].T * S.T) * p[None, :]  # (n, m)
    jj = jnp.arange(n, dtype=jnp.int32)
    ii = jnp.arange(m, dtype=jnp.int32)
    rows_up = jnp.repeat(jj, m)
    cols_up = jnp.tile(n + ii, n)
    v_up = vals_off.reshape(-1)
    rows = jnp.concatenate([jj, n + ii, rows_up, cols_up])
    cols = jnp.concatenate([jj, n + ii, cols_up, rows_up])
    vals = jnp.concatenate([d1, d2, v_up, v_up])
    dense_cap = vals.shape[0]
    full = COO((N, N), rows, cols, vals, jnp.int32(dense_cap))
    merged = full.sum_duplicates()  # drops explicit zeros? no — keeps them
    # compact nonzeros to the front within the requested capacity
    nz = merged.vals != 0
    order = jnp.argsort(jnp.logical_not(nz), stable=True)[:capacity]
    keep = jnp.arange(capacity) < jnp.sum(nz)
    return COO((N, N),
               jnp.where(keep, merged.rows[order], 0),
               jnp.where(keep, merged.cols[order], 0),
               jnp.where(keep, merged.vals[order], 0),
               jnp.minimum(jnp.sum(nz).astype(jnp.int32), capacity))
