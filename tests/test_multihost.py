"""Multi-host scaffolding (SURVEY.md section 2.3: single process ->
multi-host via ``jax.distributed.initialize``).

Real DCN hardware isn't available here; these tests check the glue: the
no-op single-process path, env-variable configuration, and a degenerate
1-process ``jax.distributed`` cluster running a sharded CLI solve
end-to-end (subprocess-isolated — distributed init is process-global).
"""

import os
import subprocess
import sys

import pytest


def test_init_multihost_noop_without_coordinator(monkeypatch):
    from otamg.dist import init_multihost

    monkeypatch.delenv("OTAMG_COORDINATOR", raising=False)
    assert init_multihost() is False  # single-process: no-op


@pytest.mark.slow
def test_one_process_cluster_cli_solve():
    """A 1-process jax.distributed cluster must run the sharded CLI solve
    end-to-end (coordinator glue + global-device mesh + --shard)."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    proc = subprocess.run(
        [sys.executable, "-m", "otamg.cli", "class1", "--m", "32",
         "--n", "32", "--shard",
         "--coordinator", "localhost:49721",
         "--num-processes", "1", "--process-id", "0"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "multi-host: process 0/1" in proc.stderr
    assert '"converged": true' in proc.stdout


@pytest.mark.slow
def test_two_process_cluster_cli_solve():
    """A GENUINE 2-process jax.distributed cluster (2 x 4 CPU devices, 8
    global) running the row-sharded Class-1 solve: cross-process init,
    Gloo collectives, and the pass-the-problem-as-jit-argument path the
    multi-controller model requires (closures over non-addressable
    arrays are rejected).  Round-3 verdict item 2."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "otamg.cli", "class1", "--m", "32",
             "--n", "32", "--shard", "--maxit", "60",
             "--coordinator", "localhost:49722",
             "--num-processes", "2", "--process-id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=cwd)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}: {err[-2000:]}"
        assert f"multi-host: process {i}/2" in err
        assert "8 global / 4 local devices" in err
        assert '"converged": true' in out
    # Multi-controller: both processes run the same program and must
    # agree on the trajectory (same iteration count and objective).
    import json

    reps = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert reps[0]["iters"] == reps[1]["iters"]
    assert reps[0]["objective"] == reps[1]["objective"]


def _run_two_proc(extra, port, timeout_s=900):
    """Launch a 2-process cluster CLI solve; return the per-process JSON
    reports (asserting rc=0)."""
    import json

    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "otamg.cli", "class1", "--m", "32",
             "--n", "32", "--shard",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i)] + extra,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=cwd)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=timeout_s) for p in procs]
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode in (0, 1), f"proc {i}: {err[-2000:]}"

    def last_json(out):
        # Gloo teardown chatter can land on stdout after the report.
        for line in reversed(out.strip().splitlines()):
            if line.startswith("{"):
                return json.loads(line)
        raise AssertionError(f"no JSON report in stdout: {out[-500:]}")

    return [last_json(out) for out, _ in outs]


@pytest.mark.slow
def test_two_process_resume(tmp_path):
    """Multi-process checkpoint/resume (round-4 verdict item 5): the
    sharded APD state is saved PER PROCESS (each controller writes only
    its addressable shards, ``diag/checkpoint.py::_save_sharded``) and a
    resumed 2-process cluster must finish on the EXACT trajectory of an
    uninterrupted run — same iteration count and bit-identical
    objective (the checkpoint carries ``resk`` so the restart heuristic
    sees the same history)."""
    ckdir = str(tmp_path / "ck")
    # Uninterrupted reference run.
    ref = _run_two_proc([], 49731)
    assert ref[0]["converged"] and ref[0]["iters"] == ref[1]["iters"]

    # Truncated run: stops at maxit 20 with checkpoints at k=10, 20.
    cut = _run_two_proc(["--maxit", "20", "--checkpoint", ckdir], 49732)
    assert not cut[0]["converged"]
    import glob

    files = glob.glob(os.path.join(ckdir, "step_20.proc*of2.npz"))
    assert len(files) == 2, "each process must write its own shard file"

    # Resume: must converge exactly where the uninterrupted run did.
    res = _run_two_proc(["--checkpoint", ckdir, "--resume"], 49733)
    for rep in res:
        assert rep["converged"]
        assert rep["iters"] == ref[0]["iters"], (
            f"resume drifted: it={rep['iters']} != {ref[0]['iters']}")
        assert rep["objective"] == ref[0]["objective"]
