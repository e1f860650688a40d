"""Distributed KKT assembly with explicit collectives (shard_map).

The reference assembles ``H0 = A diag(s) A^T`` and the hybrid transform's
``Ae = diag(g) - E/tk`` serially (``ASAt.m:9-19``, ``Hybrid_AMG.m:16-24``).
Here the plan-shaped inputs (``S`` and therefore ``E``) are row-block
sharded over the mesh's ``"x"`` axis (see :mod:`otamg.dist.api`); assembly
reduces over that axis, so the distributed form needs exactly two
collective patterns:

* column reductions (``d1 = Y^T p^2``, ``a0``'s column sums) — a local
  partial GEMV followed by ``psum`` over the interconnect;
* row-side small vectors (``d2``, ``a0``'s row sums, ``p^2``) — local
  compute plus one tiled ``all_gather`` to build the replicated
  ``(n + m)`` KKT diagonal.

The product solve path reaches the same collective structure implicitly
through the XLA SPMD partitioner (tested by HLO inspection in
``tests/test_dist.py``); these explicit shard_map versions are the
library-level distributed-assembly capability, oracle-tested against the
replicated path.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _shard_map

_P = lax.Precision.HIGHEST


def shard_map(f, *, mesh, in_specs, out_specs):
    """shard_map with the static replication check disabled: the mixed
    replicated/sharded outputs here (psum- and all_gather-produced) defeat
    the checker's inference, but are replicated by construction.  The
    keyword spells check_vma in jax >= 0.7 and check_rep before."""
    try:
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
    except TypeError:  # pragma: no cover - older jax
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_rep=False)


def asat_diags_sharded(mesh: Mesh, S, p, q, axis_name: str = "x"):
    """Distributed ``ASAt.m:9-19`` diagonals for row-sharded ``S``:
    ``d1 = Y^T (p*p)`` (replicated, one psum), ``d2 = Y (q*q)``
    (row-sharded, local)."""

    def local(S, p, q):
        d1 = lax.psum(jnp.matmul(S.T, p * p, precision=_P), axis_name)
        d2 = jnp.matmul(S, q * q, precision=_P)
        return d1, d2

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P()),
        out_specs=(P(), P(axis_name)))(S, p, q)


def transform_sharded(mesh: Mesh, S, tvec, bk1, tk, p, q,
                      axis_name: str = "x"):
    """Distributed hybrid transform (``Hybrid_AMG.m:16-24``): returns
    ``(E, g, kdiag)`` with ``E`` row-block sharded and the ``(n + m)``
    KKT diagonals replicated.  ``S``/``p`` are row-sharded; ``tvec``,
    ``q`` and the scalars are replicated."""

    def local(S, tvec, bk1, tk, p, q):
        p2 = p * p                    # local row block
        q2 = q * q                    # replicated
        E = (p2[:, None] * q2[None, :]) * S
        col = lax.psum(jnp.sum(E, axis=0), axis_name)          # (n,)
        row_full = lax.all_gather(jnp.sum(E, axis=1), axis_name,
                                  tiled=True)                  # (m,)
        p2_full = lax.all_gather(p2, axis_name, tiled=True)
        a0diag = jnp.concatenate([col, row_full])
        qp2 = jnp.concatenate([q2, p2_full])
        kdiag = qp2 * tvec
        g = bk1 * qp2 + (kdiag + a0diag) / tk
        return E, g, kdiag

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P(), P(), P(), P(axis_name), P()),
        out_specs=(P(axis_name, None), P(), P()))(
            S, tvec, jnp.asarray(bk1), jnp.asarray(tk), p, q)


def galerkin_sharded(mesh: Mesh, A, Pro, axis_name: str = "x"):
    """Distributed Galerkin triple product ``Ac = P^T A P`` for a
    row-block-sharded level operator ``A`` and replicated prolongation
    ``P`` (``transfer.m:66``).

    Each shard computes its local ``A_s P`` GEMM and the partial
    ``P_s^T (A_s P)`` contraction over its own rows; one ``psum``
    completes the sum over row blocks.  The coarse operator comes out
    replicated — the coarse-grid agglomeration point of the sharding
    design (levels at and below this size are cheap enough to replicate).
    """
    ndev = mesh.devices.size
    nrows = A.shape[0]
    assert nrows % ndev == 0, "rows must divide evenly over the mesh"
    R = nrows // ndev

    def local(A_s, Pr):
        idx = lax.axis_index(axis_name)
        AP = jnp.matmul(A_s, Pr, precision=_P)          # (R, c)
        P_s = lax.dynamic_slice_in_dim(Pr, idx * R, R)  # my row block of P
        return lax.psum(jnp.matmul(P_s.T, AP, precision=_P), axis_name)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=P())(A, Pro)


def ell_row_sum_duplicates(cols, vals, out_cap: int):
    """Per-row duplicate merge for ELL blocks: sort each row by column,
    sum runs of equal columns, and compress the merged entries into
    ``out_cap`` leading slots (groups beyond capacity are dropped by the
    scatter, never mis-accumulated).

    Padding slots (col 0 / val 0 by the container invariant) merge into a
    single zero-valued col-0 group which is dropped from the output
    entirely (real groups shift down one slot), so a compacted row keeps
    the padding invariant via its untouched trailing zero slots and the
    full ``out_cap`` is available for real groups.

    Zero-VALUED entries at arbitrary columns (e.g. products of an A
    padding slot against B's real row 0 in the SpGEMM expansion) are
    remapped to the padding column before grouping — they contribute
    nothing to the operator, and counting them as distinct groups would
    let them displace real entries under a tight ``out_cap``.

    Returns ``(out_cols, out_vals, ngroups_max)`` — the third value is the
    REAL distinct-column count of the worst row (the zero-valued padding
    group excluded — advisor r4: counting it made the flag fire on rows
    at exact-fit capacity).  ``ngroups_max > out_cap`` means real merged
    entries were dropped and the compacted operator is silently wrong:
    callers must surface it (``spgemm_rowsharded`` propagates it as its
    overflow indicator).
    """
    cols = jnp.where(vals == 0, 0, cols)
    order = jnp.argsort(cols, axis=1)
    cs = jnp.take_along_axis(cols, order, axis=1)
    vs = jnp.take_along_axis(vals, order, axis=1)
    is_new = jnp.concatenate(
        [jnp.ones_like(cs[:, :1], bool), cs[:, 1:] != cs[:, :-1]], axis=1)
    gid = jnp.cumsum(is_new, axis=1) - 1
    # A row's group 0 is padding-only iff it sits at col 0 and sums to 0
    # (a real group summing to 0 merges to a zero entry anyway — dropping
    # it is operator-neutral).  Shift it out so real groups start at
    # slot 0 (gid -1 scatters are dropped) and exclude it from the count.
    g0_sum = jnp.sum(jnp.where(gid == 0, vs, 0), axis=1)
    pad_only = jnp.logical_and(cs[:, 0] == 0, g0_sum == 0)
    gid = gid - pad_only[:, None].astype(gid.dtype)
    ngroups_max = jnp.max(gid[:, -1]) + 1
    # gid=-1 must NOT reach the scatter: JAX normalizes negative indices
    # BEFORE the mode="drop" OOB check, so -1 wraps to slot out_cap-1 and
    # can clobber a real column at exact-fit rows (scatter order with
    # duplicate indices is implementation-defined).  Remap the padding
    # group to out_cap, which is genuinely out of bounds and dropped.
    gid = jnp.where(gid < 0, out_cap, gid)
    R = cols.shape[0]
    rows = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[:, None],
                            gid.shape)
    out_c = jnp.zeros((R, out_cap), cols.dtype)
    out_v = jnp.zeros((R, out_cap), vals.dtype)
    out_c = out_c.at[rows, gid].set(cs, mode="drop")
    out_v = out_v.at[rows, gid].add(vs, mode="drop")
    return out_c, out_v, ngroups_max


def spgemm_rowsharded(mesh: Mesh, a_ell_cols, a_ell_vals, b_ell_cols,
                      b_ell_vals, axis_name: str = "x",
                      out_cap: int | None = None):
    """Distributed SpGEMM ``C = A B`` with ``A`` in row-block-sharded ELL
    form and ``B`` replicated ELL.

    Pure scatter-free expansion: output row ``i`` combines each stored
    ``A[i, k]`` with ``B``'s row ``k``, yielding an ELL row of capacity
    ``rcA * rcB`` that may contain duplicate columns — duplicates
    represent the same linear operator (SpMV sums them), and ``A``'s
    zero-padded slots carry zero values, contributing nothing.  No
    communication at all: A's rows already live where C's rows go, B is
    replicated (the framework's KKT-sized operands) — the point of the
    row-block layout.

    ``out_cap`` bounds the output row capacity by merging duplicate
    columns locally (per shard, no communication) after the expansion —
    without it, chained products (the Galerkin ``P^T A P`` chain,
    ``transfer.m:66``) grow capacity as ``rcA * rcB`` per hop.

    Returns ``(cols, vals, cap_needed)``: ``cap_needed`` is the replicated
    worst-row distinct-column count across all shards.  With ``out_cap``
    set, ``cap_needed > out_cap`` flags CAPACITY TRUNCATION — real merged
    entries were dropped and the product is wrong; callers must check
    (a silently undersized cap in a chained Galerkin product otherwise
    changes the assembled coarse operator).  Without ``out_cap`` it is the
    exact capacity a following compaction would need.
    """

    def local(acols, avals):
        bc = b_ell_cols[acols]                     # (R, rcA, rcB)
        bv = avals[..., None] * b_ell_vals[acols]  # (R, rcA, rcB)
        Rr = acols.shape[0]
        bc, bv = bc.reshape(Rr, -1), bv.reshape(Rr, -1)
        if out_cap is not None and out_cap < bc.shape[1]:
            bc, bv, need = ell_row_sum_duplicates(bc, bv, out_cap)
        else:
            # Exact need = distinct columns of the worst expanded row.
            c0 = jnp.where(bv == 0, 0, bc)
            cs = jnp.sort(c0, axis=1)
            need = jnp.max(jnp.sum(
                jnp.concatenate([jnp.ones_like(cs[:, :1], bool),
                                 cs[:, 1:] != cs[:, :-1]], axis=1)
                .astype(jnp.int32), axis=1))
        return bc, bv, lax.pmax(need, axis_name)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=(P(axis_name, None), P(axis_name, None), P()))(
            a_ell_cols, a_ell_vals)
