"""Every fp32 product of the mixed-precision solve runs at HIGHEST
precision.

Without a precision argument a GPU may round fp32 matmul operands to
TF32, which the fp32 AMG trajectory cannot absorb.  The guard lowers the
jitted Class-1 outer step (f64 state, ``solve_dtype="float32"``) and
checks every f32 ``dot_general`` in its StableHLO."""

import re

import jax
import jax.numpy as jnp
import pytest

from otamg.config import AMGOptions, APDOptions, Cycle
from otamg.opt.apd import make_class1_step
from otamg.ot import random_class1


@pytest.mark.parametrize("coarse_target", [128, 8])
def test_mixed_step_pins_fp32_dots(coarse_target):
    """``coarse_target=128`` is the production option (one coarse level at
    32^2); 8 builds a deeper hierarchy and the fused deep matrix."""
    m = n = 32
    prob = random_class1(jax.random.PRNGKey(0), m, n, dtype=jnp.float64)
    opts = APDOptions(solve_dtype="float32", amg=AMGOptions(
        cycle=Cycle.F, fuse_deep=True, coarse_target=coarse_target))
    step = make_class1_step(prob, opts)
    X = jnp.zeros((m, n))
    one = jnp.asarray(1.0)
    text = step.lower(jnp.asarray(1, jnp.int32), X, X, jnp.zeros(n + m),
                      one, jax.random.PRNGKey(1), 10 * one,
                      jnp.stack([one, one]), prob).as_text()
    dots = [ln for ln in text.splitlines() if "stablehlo.dot_general" in ln]
    f32 = [ln for ln in dots if re.search(r"tensor<[0-9x]*xf32>", ln)]
    assert f32, "the mixed step has no fp32 products to check"
    loose = [ln.strip() for ln in f32 if "HIGHEST" not in ln]
    assert not loose, "fp32 dot_general without HIGHEST:\n" + "\n".join(
        loose[:5])
