"""``chip_smoke.py`` and ``bench.py`` on the CPU: both refuse to run
without a GPU, and the smoke's phase functions pass at tiny sizes."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# CPU pins of phase c at 48^2, recorded with
#   JAX_PLATFORMS=cpu python -c 'import chip_smoke; chip_smoke.print_pins(48)'
PINS_48 = {
    "class1": {"iters": 62, "fails": 0, "objective": 1.152318901757327},
    "class2": {"iters": 45, "fails": 0, "objective": 0.2147431952563172},
}


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    """Non-zero exit before any solve, and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout and "metric" not in out.stdout


def test_phase_precision_tiny():
    """Phase b at 64^2 (a small coarsest target keeps two coarse levels):
    every fp32 product agrees with the f64 NumPy reference."""
    rec = chip_smoke.phase_precision(64, spmv_shapes=((256, 20),),
                                     coarse_target=16)
    assert len(rec["levels"]) >= 3
    assert max(rec["rel_err"].values()) <= chip_smoke.TOL_PRECISION


def test_phase_trajectory_tiny(capsys):
    """Phase c at 48^2 against its CPU pins: converged, no AMG failures,
    iterations and objective on the pins, and a bit-identical rerun."""
    rec = chip_smoke.phase_trajectory(48, PINS_48)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "trajectory" and line["ok"]
    for cls in ("class1", "class2"):
        assert rec[cls]["iter_drift"] == 0
    assert all(rec["class1_rerun_bit_identical"].values())
    assert rec["class1_all_f64"]["converged"]
