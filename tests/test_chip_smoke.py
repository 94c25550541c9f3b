"""chip_smoke.py off the card: it refuses the CPU, its last line carries
exactly the contract's keys, and its checks pass on a tiny problem."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_error_checks_pass_on_tiny_problem():
    rng = np.random.default_rng(3)
    t = np.linspace(0, 2 * np.pi, 77, endpoint=False)
    sx, sy = 1.3 * np.cos(t), 1.3 * np.sin(t)
    w = np.full(t.size, 2 * np.pi * 1.3 / t.size)
    tx, ty = rng.uniform(-0.8, 0.8, (2, 301))
    rows = chip_smoke.check_dense_applies(sx, sy, w, tx, ty, seed=1)
    assert [r[0] for r in rows] == ["laplace_slp_apply",
                                    "laplace_slp_grad_apply",
                                    "mh_slp_apply", "stokes_slp_apply"]
    for name, err, bound in rows:
        assert 0 < bound and err <= bound, (name, err, bound)
    rel, native = chip_smoke.check_box_solve(24, 34)
    assert native and rel <= chip_smoke.FFT_RTOL
