"""Graph algorithms for AMG setup (layer L3) — all on-device, static shapes.

Replaces the reference's native graph layer with jittable equivalents:

* :func:`connected_components_bipartite` replaces SuiteSparse ``dmperm``
  (``components.m:36``) with min-label propagation + pointer-jumping
  compression on the bipartite edge mask — O(log diameter) rounds, each a
  masked min-reduction over the ``(m, n)`` grid.
* :func:`strength_dense` is ``AMG/strength.m`` (symmetrized case 2) on a
  capacity-padded dense matrix with an activity mask.
* :func:`mis_dense` is the approximate-MIS C/F splitting of
  ``AMG/mis_set.m`` (from Long Chen's iFEM), vectorised: the greedy
  local-max-degree selection becomes a masked neighborhood max per round.

Randomness (tie-breaks, bail-out sampling) uses threaded ``jax.random``
keys instead of MATLAB's global ``rand`` stream — reproducible by seed;
trajectory parity with the reference is tolerance-based, not bitwise
(SURVEY.md section 7, hard part (e)).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def connected_components_bipartite(E_mask: jax.Array,
                                   max_rounds: int = 64) -> jax.Array:
    """Connected-component labels of the bipartite graph whose edges are
    ``E_mask[i, j] != 0`` between row node ``n + i`` and column node ``j``.

    Node ordering matches the KKT system: columns (q-side) are nodes
    ``0..n-1``, rows (p-side) are ``n..n+m-1``.  Returns an ``(n + m,)``
    int32 vector; each node's label is the smallest node index in its
    component (so labels are stable component representatives).
    """
    m, n = E_mask.shape
    has_edge = E_mask != 0
    big = jnp.int32(n + m)

    L0 = jnp.arange(n + m, dtype=jnp.int32)

    def body(carry):
        L, _, rounds = carry
        lc, lr = L[:n], L[n:]
        # Hook: pull the minimum neighbor label across the bipartite edges.
        lr2 = jnp.minimum(lr, jnp.min(
            jnp.where(has_edge, lc[None, :], big), axis=1))
        lc2 = jnp.minimum(lc, jnp.min(
            jnp.where(has_edge, lr2[:, None], big), axis=0))
        L2 = jnp.concatenate([lc2, lr2])
        # Compress: pointer-jump twice so label chains halve each round.
        L2 = L2[L2]
        L2 = L2[L2]
        return L2, jnp.any(L2 != L), rounds + 1

    def cond(carry):
        _, changed, rounds = carry
        return jnp.logical_and(changed, rounds < max_rounds)

    L, _, _ = lax.while_loop(cond, body, (L0, jnp.bool_(True), jnp.int32(0)))
    return L


def component_stats(labels: jax.Array, weights: jax.Array):
    """Per-node component size and per-node sum of ``weights`` over the
    node's component, via segment reductions keyed on representative
    labels (static ``num_segments`` = number of nodes)."""
    N = labels.shape[0]
    ones = jnp.ones_like(weights)
    sizes = jax.ops.segment_sum(ones, labels, num_segments=N)
    wsums = jax.ops.segment_sum(weights, labels, num_segments=N)
    return sizes[labels], wsums[labels]


def strength_dense(A: jax.Array, active: jax.Array) -> jax.Array:
    """Strength-of-connection values (``AMG/strength.m``, symmetrized
    case 2): ``S_ij = a0_ij / min(maxrow_i, maxrow_j)`` with ``A0 = D - A``
    (negated off-diagonals, zero diagonal).  Padded rows/cols return 0."""
    N = A.shape[0]
    eye = jnp.eye(N, dtype=bool)
    act2 = jnp.logical_and(active[:, None], active[None, :])
    offmask = jnp.logical_and(act2, jnp.logical_not(eye))
    A0 = jnp.where(offmask, -A, 0.0)
    max_row = jnp.max(jnp.where(offmask, A0, -jnp.inf), axis=1)
    max_row = jnp.where(max_row <= 0, jnp.inf, max_row)
    denom = jnp.minimum(max_row[:, None], max_row[None, :])
    return jnp.where(offmask, A0 / denom, 0.0)


class CFSplit(NamedTuple):
    isC: jax.Array
    isF: jax.Array   # undecided leftovers are neither C nor F (see mis_dense)


def mis_dense(As: jax.Array, active: jax.Array, key: jax.Array,
              max_rounds: int = 64) -> CFSplit:
    """Approximate-MIS C/F splitting (``AMG/mis_set.m``), dense/masked.

    ``As`` is the boolean strong-connection matrix (off-diagonal, already
    thresholded by ``theta``).  Faithfully reproduces: the random bail-out
    when too few nodes are connected (``mis_set.m:30-34``), random degree
    tie-breaking (``:35``), greedy local-max selection rounds (``:42-65``)
    stopping at ``|C| >= N/2`` or ``<= N0`` undecided, isolated-node F
    assignment (``:40``) and the final strength-isolated override to C
    (``:67``).  As in the reference, when the loop exits on ``|C| >= N/2``
    any still-undecided nodes end up neither C nor F (they receive zero
    interpolation rows downstream, exactly like ``transfer.m:63``'s
    permutation scatter leaves them zero).
    """
    N = As.shape[0]
    fdtype = jnp.float32
    Ncnt = jnp.sum(active).astype(fdtype)
    N0 = jnp.minimum(jnp.floor(jnp.sqrt(Ncnt)) + 1, 25.0)

    deg0 = jnp.sum(jnp.where(As, 1.0, 0.0), axis=1).astype(fdtype)
    deg0 = jnp.where(active, deg0, 0.0)
    connected = jnp.sum((deg0 > 0).astype(fdtype))

    kb, kt = jax.random.split(key)

    def bailout(_):
        # Too few connected nodes: pick ~N0 random active coarse nodes
        # (smoother alone is a good preconditioner there, mis_set.m:30-34).
        score = jax.random.uniform(kb, (N,), fdtype)
        score = jnp.where(active, score, jnp.inf)
        # Dense rank of each node: the inverse of the sort permutation,
        # by scatter.  (argsort of an argsort trips an XLA GPU pass —
        # permutation_sort_simplifier — into invalid HLO with int64
        # indices.)
        order = jnp.argsort(score)
        rank = jnp.zeros(N, order.dtype).at[order].set(
            jnp.arange(N, dtype=order.dtype), unique_indices=True)
        isC = jnp.logical_and(active, rank < N0.astype(rank.dtype))
        isF = jnp.logical_and(active, jnp.logical_not(isC))
        return CFSplit(isC, isF)

    def greedy(_):
        tie = 0.1 * jax.random.uniform(kt, (N,), fdtype)
        deg = jnp.where(deg0 > 0, deg0 + tie, 0.0)
        isF0 = jnp.logical_and(active, deg0 == 0)
        isC0 = jnp.zeros(N, bool)
        isU0 = jnp.logical_and(active, jnp.logical_not(isF0))

        def cond(c):
            isC, isF, isU, deg, rounds = c
            return ((jnp.sum(isC) < Ncnt / 2)
                    & (jnp.sum(isU) > N0)
                    & (rounds < max_rounds))

        def body(c):
            isC, isF, isU, deg, rounds = c
            isS = deg > 0
            # Local max degree within the selected subgraph survives
            # (ties broken by the random perturbation above).
            nbr = jnp.where(jnp.logical_and(As, isS[None, :]),
                            deg[None, :], -jnp.inf)
            nbrmax = jnp.max(nbr, axis=1)
            sel = jnp.logical_and(isS, deg > nbrmax)
            isC = jnp.logical_or(isC, sel)
            nbrC = jnp.any(jnp.logical_and(As, isC[None, :]), axis=1)
            isF = jnp.logical_or(isF, jnp.logical_and(
                nbrC, jnp.logical_and(active, jnp.logical_not(isC))))
            isU = jnp.logical_and(active, jnp.logical_not(isF | isC))
            deg = jnp.where(isU, deg, 0.0)
            # <= N0 undecided left: absorb them into C (mis_set.m:60-63).
            absorb = jnp.sum(isU) <= N0
            isC = jnp.logical_or(isC, jnp.logical_and(absorb, isU))
            isU = jnp.logical_and(isU, jnp.logical_not(absorb))
            return isC, isF, isU, deg, rounds + 1

        isC, isF, isU, _, _ = lax.while_loop(
            cond, body, (isC0, isF0, isU0, deg, jnp.int32(0)))
        # Tiny-level guard: with <= N0 active nodes the loop never runs
        # and C stays empty — the reference never reaches this state
        # because it stops coarsening on the *actual* level size
        # (Class_AMG.m:76) while our static capacity schedule keeps
        # going.  An empty C set would zero out every deeper level, so
        # absorb the undecided nodes into C (the loop's own <= N0
        # absorption rule, applied to the degenerate entry case).
        none = jnp.logical_not(jnp.any(isC))
        isC = jnp.logical_or(isC, jnp.logical_and(none, isU))
        return CFSplit(isC, jnp.logical_and(isF, jnp.logical_not(isC)))

    isC, isF = lax.cond(connected < 0.25 * jnp.sqrt(Ncnt), bailout, greedy,
                        operand=None)
    # Strength-isolated nodes are forced to C (mis_set.m:67).
    iso = jnp.logical_and(active, jnp.logical_not(jnp.any(As, axis=1)))
    isC = jnp.logical_or(isC, iso)
    isF = jnp.logical_and(isF, jnp.logical_not(iso))
    return CFSplit(isC, isF)
