"""CLI, metrics, and checkpoint/resume tests."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from otamg.config import APDOptions, InnerSolver
from otamg.opt import solve_class1
from otamg.ot import random_class1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def test_cli_class1_small(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "otamg.cli", "class1", "--m", "16",
         "--n", "12", "--inner", "pcg",
         "--log", str(tmp_path / "log.jsonl")],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["converged"]
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(lines) == rep["iters"] + 1


def test_cli_class1_chunked_driver(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "otamg.cli", "class1", "--m", "16",
         "--n", "12", "--inner", "pcg", "--driver", "chunked",
         "--chunk", "4"],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["converged"]


def test_cli_info():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "otamg.cli", "info"],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0
    rep = json.loads(out.stdout)
    assert rep["backend"] == "cpu"


def test_checkpoint_resume(tmp_path):
    """Interrupting at iteration K and resuming must reach the same final
    state as an uninterrupted run (restart-free trajectory)."""
    prob = random_class1(jax.random.PRNGKey(5), 16, 12)
    opts = APDOptions(inner_solver=InnerSolver.PCG, maxit=20,
                      kkt_tol=1e-30)  # force fixed-length runs
    ck = str(tmp_path / "ck")
    full = solve_class1(prob, opts)
    part = solve_class1(prob, APDOptions(inner_solver=InnerSolver.PCG,
                                         maxit=10, kkt_tol=1e-30),
                        checkpoint_dir=ck, checkpoint_every=5)
    resumed = solve_class1(prob, opts, checkpoint_dir=ck, resume=True)
    np.testing.assert_allclose(np.asarray(resumed.X), np.asarray(full.X),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(resumed.lam),
                               np.asarray(full.lam), rtol=1e-10,
                               atol=1e-12)


def test_sharded_checkpoint_roundtrip(tmp_path, monkeypatch):
    """Per-shard save/load (the multi-process layout, forced on a single
    process by patching the process-count probe): shards written per
    addressable device with index metadata, reassembled bit-exactly
    against a template sharding via
    make_array_from_single_device_arrays."""
    import jax.numpy as jnp

    from otamg.diag import checkpoint as ckpt
    from otamg.dist import make_mesh

    if len(jax.devices()) < 4:
        import pytest

        pytest.skip("needs >= 4 devices")
    monkeypatch.setattr(ckpt, "_is_multiprocess", lambda: True)
    mesh = make_mesh(4)
    from jax.sharding import NamedSharding, PartitionSpec

    sh = NamedSharding(mesh, PartitionSpec("x", None))
    X = jax.device_put(jnp.arange(48.0).reshape(8, 6), sh)
    rep = jax.device_put(jnp.linspace(0.0, 1.0, 7),
                         NamedSharding(mesh, PartitionSpec()))
    lam = jnp.linspace(0.0, 1.0, 7)  # unsharded
    path = str(tmp_path / "ck")
    ckpt.save_dict(path, 10, dict(X=X, rep=rep, lam=lam,
                                  bk=jnp.float64(0.5)))
    assert ckpt.latest_step(path) == 10
    assert os.path.exists(os.path.join(path, "step_10.proc0of1.npz"))
    d = ckpt.load_dict(path, template=dict(X=X))
    assert d["k"] == 10
    np.testing.assert_array_equal(np.asarray(d["X"]), np.asarray(X))
    assert d["X"].sharding == sh
    # Fully-replicated arrays round-trip as one local copy.
    np.testing.assert_array_equal(np.asarray(d["rep"]), np.asarray(rep))
    np.testing.assert_array_equal(np.asarray(d["lam"]), np.asarray(lam))
    assert float(d["bk"]) == 0.5


def test_multiproc_checkpoint_single_process_restore(tmp_path):
    """A SINGLE-process restore of a MULTI-process run's artifacts must
    stitch the global arrays back together from all proc files (round-5
    review: the old fallback probed step_{k}.proc0of1.npz, a filename no
    real run writes, and crashed with FileNotFoundError instead)."""
    import json

    import jax.numpy as jnp

    from otamg.diag import checkpoint as ckpt

    path = tmp_path / "ck_mp"
    path.mkdir()
    X = np.arange(48.0).reshape(8, 6)
    lam = np.linspace(0.0, 1.0, 7)
    # Emulate a 2-process save (2 row-block shards per process), exactly
    # the layout _save_sharded writes.
    for pid, rows in ((0, [(0, 2), (2, 4)]), (1, [(4, 6), (6, 8)])):
        data = {f"X__s{si}": X[a:b] for si, (a, b) in enumerate(rows)}
        meta = {"X": [json.dumps([[a, b], [0, 6]]) for a, b in rows]}
        np.savez(path / f"step_7.proc{pid}of2.npz", k=7,
                 __meta__=json.dumps(meta), lam=lam, **data)
    assert ckpt.latest_step(str(path)) == 7
    d = ckpt.load_dict(str(path))
    assert d["k"] == 7
    np.testing.assert_array_equal(np.asarray(d["X"]), X)
    np.testing.assert_array_equal(np.asarray(d["lam"]), lam)
    # With a template, the reassembled array lands on its sharding.
    if len(jax.devices()) >= 4:
        from jax.sharding import NamedSharding, PartitionSpec

        from otamg.dist import make_mesh

        sh = NamedSharding(make_mesh(4), PartitionSpec("x", None))
        t = jax.device_put(jnp.zeros((8, 6)), sh)
        d2 = ckpt.load_dict(str(path), template=dict(X=t))
        assert d2["X"].sharding == sh
        np.testing.assert_array_equal(np.asarray(d2["X"]), X)


def test_class2_cross_driver_resume(tmp_path):
    """A checkpoint written by the class-2 LOOP driver must resume in the
    CHUNKED driver and vice versa (round-5 review: the loop driver saved
    the restart residual under 'prev' while the chunked driver expected
    'prev_kkt' — crossing drivers either crashed or silently reset the
    restart heuristic's history)."""
    from otamg.opt.apd2 import solve_class2, solve_class2_chunked
    from otamg.ot import random_class2

    prob = random_class2(jax.random.PRNGKey(8), 12, 10, mu_frac=0.5)

    def mkopts(maxit):
        return APDOptions(ssn_tol1=1e-10, maxit=maxit, kkt_tol=1e-30,
                          inner_solver=InnerSolver.AUG_PCG)

    full = solve_class2(prob, mkopts(16))
    # loop checkpoint -> chunked resume
    ck = str(tmp_path / "ck_lc")
    solve_class2(prob, mkopts(8), checkpoint_dir=ck, checkpoint_every=4)
    r1 = solve_class2_chunked(prob, mkopts(16), chunk=4,
                              checkpoint_dir=ck, resume=True)
    np.testing.assert_allclose(np.asarray(r1.X), np.asarray(full.X),
                               rtol=1e-10, atol=1e-12)
    # chunked checkpoint -> loop resume
    ck2 = str(tmp_path / "ck_cl")
    solve_class2_chunked(prob, mkopts(8), chunk=4, checkpoint_dir=ck2)
    r2 = solve_class2(prob, mkopts(16), checkpoint_dir=ck2, resume=True)
    np.testing.assert_allclose(np.asarray(r2.X), np.asarray(full.X),
                               rtol=1e-10, atol=1e-12)


def test_solver_report_and_plot(tmp_path):
    from otamg.diag import plot_run, solver_report

    prob = random_class1(jax.random.PRNGKey(6), 12, 10)
    res = solve_class1(prob, APDOptions(inner_solver=InnerSolver.PCG))
    rep = solver_report(res)
    assert rep["converged"] and rep["iters"] == res.iters
    paths = plot_run(res, str(tmp_path / "run"))
    for p in paths:
        assert os.path.exists(p)


def test_solver_report_component_info():
    """The reference's ``info = [num_comp, it_num]`` (``Hybrid_AMG.m:113``)
    surfaces through the AMG path: num_comp >= 1 always, and on a
    >100-node connected active set the last-large-component ordinal is
    nonzero (the 100-node crossover, ``Hybrid_AMG.m:51``)."""
    from otamg.diag import solver_report

    prob = random_class1(jax.random.PRNGKey(7), 60, 60)
    res = solve_class1(prob, APDOptions(inner_solver=InnerSolver.AMG,
                                        maxit=3, kkt_tol=1e-30))
    rep = solver_report(res)
    assert rep["ncomp"] >= 1
    assert rep["last_large"] >= 1  # 120-node KKT graph: one big component
    assert res.info_ncomp.shape == (3,)
    assert (res.info_last <= res.info_ncomp).all()


def test_chunked_checkpoint_resume(tmp_path):
    """The chunked driver checkpoints at chunk boundaries and resumes with
    an exactly-identical trajectory (round-2 verdict item 10)."""
    from otamg.opt import solve_class1_chunked

    prob = random_class1(jax.random.PRNGKey(9), 16, 12)
    opts = APDOptions(inner_solver=InnerSolver.PCG, maxit=20,
                      kkt_tol=1e-30)
    full = solve_class1_chunked(prob, opts, chunk=4)
    ck = str(tmp_path / "ckc")
    solve_class1_chunked(prob, APDOptions(inner_solver=InnerSolver.PCG,
                                          maxit=12, kkt_tol=1e-30),
                         chunk=4, checkpoint_dir=ck)
    resumed = solve_class1_chunked(prob, opts, chunk=4,
                                   checkpoint_dir=ck, resume=True)
    np.testing.assert_allclose(np.asarray(resumed.X), np.asarray(full.X),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(resumed.lam),
                               np.asarray(full.lam), rtol=1e-10,
                               atol=1e-12)


def test_chunked_checkpoint_resume_class2(tmp_path):
    from otamg.opt.apd2 import solve_class2_chunked
    from otamg.ot import random_class2

    prob = random_class2(jax.random.PRNGKey(10), 12, 10, mu_frac=0.5)
    opts = APDOptions(ssn_tol1=1e-10, maxit=16, kkt_tol=1e-30,
                      inner_solver=InnerSolver.AUG_PCG)
    full = solve_class2_chunked(prob, opts, chunk=4)
    ck = str(tmp_path / "ckc2")
    solve_class2_chunked(prob, APDOptions(ssn_tol1=1e-10, maxit=8,
                                          kkt_tol=1e-30,
                                          inner_solver=InnerSolver.AUG_PCG),
                         chunk=4, checkpoint_dir=ck)
    resumed = solve_class2_chunked(prob, opts, chunk=4,
                                   checkpoint_dir=ck, resume=True)
    np.testing.assert_allclose(np.asarray(resumed.X), np.asarray(full.X),
                               rtol=1e-10, atol=1e-12)


def test_checkpoint_resume_class2(tmp_path):
    from otamg.opt.apd2 import solve_class2
    from otamg.ot import random_class2

    prob = random_class2(jax.random.PRNGKey(8), 12, 10, mu_frac=0.5)
    base = APDOptions(ssn_tol1=1e-10, inner_solver=InnerSolver.AUG_PCG)
    full = solve_class2(prob, APDOptions(ssn_tol1=1e-10, maxit=16,
                                         kkt_tol=1e-30,
                                         inner_solver=InnerSolver.AUG_PCG))
    ck = str(tmp_path / "ck2")
    solve_class2(prob, APDOptions(ssn_tol1=1e-10, maxit=8, kkt_tol=1e-30,
                                  inner_solver=InnerSolver.AUG_PCG),
                 checkpoint_dir=ck, checkpoint_every=4)
    resumed = solve_class2(prob, APDOptions(ssn_tol1=1e-10, maxit=16,
                                            kkt_tol=1e-30,
                                            inner_solver=InnerSolver.AUG_PCG),
                           checkpoint_dir=ck, resume=True)
    np.testing.assert_allclose(np.asarray(resumed.X), np.asarray(full.X),
                               rtol=1e-10, atol=1e-12)


def test_cli_profile_captures_trace(tmp_path):
    """--profile wraps the solve in a jax.profiler trace (SURVEY.md
    section 5.1) and writes a viewable artifact."""
    import glob

    from otamg.cli import main

    tdir = str(tmp_path / "trace")
    rc = main(["class1", "--m", "12", "--n", "12", "--inner", "pcg",
               "--profile", tdir])
    assert rc == 0
    assert glob.glob(os.path.join(tdir, "plugins", "profile", "*")), \
        "no profiler trace written"


def test_roofline_model_sanity():
    """The bytes model must scale linearly in cycle count, count the
    deep tape per-cycle when unfused, and charge the (amortized) build
    instead when fused."""
    from otamg.diag.roofline import roofline_report, solve_bytes_model

    caps = [500, 313, 196, 123]
    kw = dict(m=500, n=500, iters=58, ssn_total=100, smoth=5, gamma=3,
              caps=caps)
    b1 = solve_bytes_model(cycles_total=500, fuse_deep=False, **kw)
    b2 = solve_bytes_model(cycles_total=1000, fuse_deep=False, **kw)
    assert b2 > b1 > 0
    bf = solve_bytes_model(cycles_total=500, fuse_deep=True, **kw)
    # Fused replaces per-cycle deep-tape traffic with one GEMV + an
    # amortized build: at 500 cycles / 100 solves it must model fewer
    # deep bytes than the unfused tape.
    assert bf < b1
    rep = roofline_report(b1, 10.0, "NVIDIA H100 80GB HBM3")
    assert rep["model_gbps"] > 0 and 0 < rep["roofline_frac"] < 1
    assert rep["roofline_frac"] == rep["model_gbps"] / 3350.0


@pytest.mark.parametrize("kind,known", [("NVIDIA H100 80GB HBM3", True),
                                        ("NVIDIA H100 PCIe", True),
                                        ("NVIDIA A100-SXM4-80GB", False),
                                        ("cpu", False)])
def test_device_peaks(kind, known):
    """Peaks come from one table keyed by device kind; a device not in it
    is an error, never a default."""
    from otamg.diag.roofline import device_peaks, roofline_report

    if known:
        pk = device_peaks(kind)
        assert pk.hbm_gbps > 1000 and pk.fp32_tflops < pk.bf16_tflops
        return
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
    with pytest.raises(KeyError):
        roofline_report(1e9, 1.0, kind)


_CACHE_PROBE = """
import json, jax
from otamg.config import enable_compile_cache
before = jax.config.jax_compilation_cache_dir
got = enable_compile_cache()
print(json.dumps([before, got, jax.config.jax_compilation_cache_dir]))
"""


@pytest.mark.parametrize("case", ["env_dir", "default", "opt_out"])
def test_compile_cache_rule(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory is the only cache and
    nothing else is set.  Unset: <checkout>/.jax_cache.
    OTAMG_NO_COMPILE_CACHE=1: no cache.  (Each case in a fresh process, so
    this session's JAX config is untouched.)"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "OTAMG_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if case == "env_dir":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    elif case == "opt_out":
        env["OTAMG_NO_COMPILE_CACHE"] = "1"
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    before, got, after = json.loads(out.stdout.strip().splitlines()[-1])
    if case == "env_dir":
        assert got == after == before == str(tmp_path)
    elif case == "default":
        assert before is None
        assert got == after == os.path.join(REPO, ".jax_cache")
    else:
        assert got is None and after is None
