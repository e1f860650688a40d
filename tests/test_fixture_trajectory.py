"""Fixture-trajectory regression contracts (SURVEY.md section 4).

The repo's most important numerical invariants: the reference 500x500
input fixtures converge in an exact iteration count through the AMG inner
solver — Class-1 ``data1-500.mat`` at it=58 (f64 AND the fp32
mixed-precision solver path identically; ``Class1/APD_SsN_Class1.m:264-268``)
and Class-2 ``data4-500.mat`` at it=53
(``Class2/APD_SsN_Class2.m:276-280``).  A coarsening/smoothing/precision
tweak that drifts the trajectory must fail here, not in a benchmark.
"""

import os

import pytest

from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver
from otamg.opt import solve_class1
from otamg.opt.apd2 import solve_class2
from otamg.ot import load_class1_mat, load_class2_mat

pytestmark = pytest.mark.slow


def _skip_unless(path):
    if not os.path.exists(path):
        pytest.skip(f"reference fixture {path} not available")


# The F-cycle (the bench's configuration) must reproduce the reference
# W-cycle trajectory exactly — validated at 58/58 (c1, both precisions),
# 53 (c2), 52 (256^2), 51 (1024^2).
@pytest.mark.parametrize("solve_dtype,cycle,fuse", [
    (None, Cycle.W, False), ("float32", Cycle.W, False),
    ("float32", Cycle.F, False),
    # The bench's configuration: fused deep correction (one
    # matrix per Newton solve, one GEMV per cycle) must keep the pin.
    ("float32", Cycle.F, True)])
def test_class1_fixture_it58(class1_fixture_path, solve_dtype, cycle, fuse):
    _skip_unless(class1_fixture_path)
    prob = load_class1_mat(class1_fixture_path)
    opts = APDOptions(inner_solver=InnerSolver.AMG, solve_dtype=solve_dtype,
                      amg=AMGOptions(cycle=cycle, fuse_deep=fuse))
    res = solve_class1(prob, opts)
    assert res.converged
    assert res.iters == 58, f"trajectory drift: it={res.iters} != 58"
    assert res.fail_count == 0
    # W-cycle budget: every AMG solve stays well under the reference
    # maxit=30 (observed max 10-11 cycles).
    assert int(res.solver_itnum[:, 2].max()) <= 12
    assert not res.restarts.any()


_SHARDED_TRAJ_CHILD = """
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver
from otamg.opt.apd2 import solve_class2
from otamg.ot import load_class2_mat
from otamg.dist import make_mesh, shard_class2

polish = sys.argv[1] == "1"
prob = load_class2_mat(sys.argv[2])
prob = shard_class2(prob, make_mesh(4))  # 500 % 4 == 0
opts = APDOptions(inner_solver=InnerSolver.AMG, ssn_tol1=1e-10,
                  solve_dtype="float32",
                  amg=AMGOptions(maxit=40, smoth=10, cycle=Cycle.F,
                                 fuse_deep=True),
                  feas_polish=polish)
res = solve_class2(prob, opts)
print("CHILD " + json.dumps(dict(
    converged=bool(res.converged), iters=int(res.iters),
    fails=int(res.fail_count), polished=bool(res.polished))))
"""


@pytest.mark.parametrize("polish,want_it", [(False, 53), (True, 47)])
def test_class2_sharded_mixed_trajectory(class2_fixture_path, polish,
                                         want_it):
    """Contract tests for the path the bench runs on the accelerator: the
    fp32 mixed-precision solver with the F-cycle + fused deep correction
    on a 4-device CPU mesh reproduces the pinned trajectories exactly —

    * polish OFF (the bench default): the solver itself closes the
      feasibility tail at it=53, fails=0 — matching the CPU f64 count.
    * polish ON (the tail safeguard): the dual-aware polish accepts at
      it=47.

    Tail regressions on the mixed path fail here in CI, not on the chip.
    Runs in a SUBPROCESS: compiling this large sharded program inside a
    pytest process that already compiled ~70 others segfaulted XLA:CPU
    sporadically (three distinct crash sites across runs — cache write,
    cache read, backend_compile — all at this test, never standalone).
    """
    import json
    import subprocess
    import sys

    _skip_unless(class2_fixture_path)
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs a 4-device mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OTAMG_NO_COMPILE_CACHE="1")
    proc = subprocess.run(
        [sys.executable, "-c", _SHARDED_TRAJ_CHILD,
         "1" if polish else "0", class2_fixture_path],
        capture_output=True, text=True, timeout=3000, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = next(json.loads(l[6:]) for l in proc.stdout.splitlines()
               if l.startswith("CHILD "))
    assert rep["converged"]
    assert rep["iters"] == want_it, \
        f"mixed-path drift: it={rep['iters']} != {want_it}"
    assert rep["polished"] == polish
    if not polish:
        assert rep["fails"] == 0


_C2_PIN_CHILD = """
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
from otamg.config import AMGOptions, APDOptions, Cycle, InnerSolver
from otamg.opt.apd2 import solve_class2
from otamg.ot import load_class2_mat

solve_dtype = None if sys.argv[1] == "none" else sys.argv[1]
cycle = Cycle[sys.argv[2]]
fuse = sys.argv[3] == "1"
prob = load_class2_mat(sys.argv[4])
amg = (AMGOptions(cycle=cycle) if cycle == Cycle.W
       else AMGOptions(maxit=40, smoth=10, cycle=cycle, fuse_deep=fuse))
opts = APDOptions(inner_solver=InnerSolver.AMG, ssn_tol1=1e-10,
                  solve_dtype=solve_dtype, amg=amg)
res = solve_class2(prob, opts)
print("CHILD " + json.dumps(dict(converged=bool(res.converged),
                                 iters=int(res.iters))))
"""


@pytest.mark.parametrize("solve_dtype,cycle,fuse", [
    (None, Cycle.W, False), ("float32", Cycle.W, False),
    (None, Cycle.F, False), (None, Cycle.F, True)])
def test_class2_fixture_it53(class2_fixture_path, solve_dtype, cycle, fuse):
    """Class-2 contract in BOTH precisions: the fp32 mixed-precision
    architecture (f64 APD state, fp32 AMG hierarchy with deflated
    refinement) must reproduce the f64 trajectory exactly — the Class-2
    analogue of the Class-1 fp32 pin, so a mixed-path divergence (as in
    the round-2 Class-1 bug) cannot ship silently.  The F-cycle variant
    pins the bench's configuration.

    SUBPROCESS-isolated like test_class2_sharded_mixed_trajectory: XLA:CPU
    sporadically segfaults compiling a large class-2 program as the
    ~70th compilation inside one pytest process (compiler-state
    exhaustion; never reproduces standalone)."""
    import json
    import subprocess
    import sys

    _skip_unless(class2_fixture_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OTAMG_NO_COMPILE_CACHE="1")
    proc = subprocess.run(
        [sys.executable, "-c", _C2_PIN_CHILD,
         solve_dtype or "none", cycle.name, "1" if fuse else "0",
         class2_fixture_path],
        capture_output=True, text=True, timeout=3000, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = next(json.loads(l[6:]) for l in proc.stdout.splitlines()
               if l.startswith("CHILD "))
    assert rep["converged"]
    assert rep["iters"] == 53, \
        f"trajectory drift: it={rep['iters']} != 53"
