"""ELL sparse matrix-vector product for the sparse layer.

SpMV is bandwidth-bound: its floor is streaming ``vals`` + ``cols`` once.
The gather + row-sum below is left to XLA, whose GPU backend fuses the
gather, the product and the reduction into one pass over the ELL arrays.
The distributed row-partitioned SpMV with halo exchange lives in
:mod:`otamg.dist.spmv`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ell_spmv(ell_cols: jax.Array, ell_vals: jax.Array,
             x: jax.Array) -> jax.Array:
    """ELL SpMV: ``y_i = sum_r vals[i,r] * x[cols[i,r]]``.

    Out-of-range padding columns gather 0 (``mode='fill'``), so a caller
    whose padding violates the col-0/val-0 invariant still gets the
    product of the stored entries."""
    return jnp.sum(ell_vals * jnp.take(x, ell_cols, axis=0, mode="fill",
                                       fill_value=0),
                   axis=1)
