"""chip_smoke.py on the CPU: its phases at 16^3-32^3 with the platform
check injected (the card run uses 512^3/1024^3 and refuses anything but a
GPU), its refusal of a CPU device, and the float64 bounds it checks
against."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
SMALL = {"stencil": 16, "mgcg": (16, 32), "fft": 16, "compact": 16,
         "demo": 16, "multi_mgcg": 32, "multi_fft": 16}


class _Dev:
    def __init__(self, platform):
        self.platform = platform
        self.device_kind = f"a {platform} device"


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", False),
                                         ("rocm", False)])
def test_require_platform(platform, ok):
    if ok:
        chip_smoke.require_platform([_Dev(platform)])
    else:
        with pytest.raises(SystemExit):
            chip_smoke.require_platform([_Dev(platform)])


def test_refuses_cpu_device(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([], sizes=SMALL, cards=[CARD])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("phase,n", [
    ("stencil", 16), ("mgcg", 16), ("mgcg", 32), ("fft", 16), ("fft", 32),
    ("compact", 16), ("compact", 32), ("demo", 16)])
def test_phase(phase, n):
    line = getattr(chip_smoke, f"phase_{phase}")(n, CARD)
    assert line.startswith("phase ") and f"card: {CARD}" in line
    assert "first call (compile+run)" in line and "warm" in line


def test_multi_phase_on_virtual_devices():
    lines = chip_smoke.phase_multi(32, 16, CARD)
    assert len(lines) == 2
    assert f"over {len(jax.devices())} devices" in lines[0]


def test_multi_needs_four_devices():
    # the CPU test mesh has 8 virtual devices, not the 4 cards --multi runs on
    if len(jax.devices()) == chip_smoke.MULTI_DEVICES:
        pytest.skip("exactly four devices present")
    with pytest.raises(chip_smoke.SmokeFailure, match="needs 4 devices"):
        chip_smoke.main(["--multi"], platform="cpu", sizes=SMALL, cards=[CARD])


def test_main_prints_ok_line_last(capsys):
    assert chip_smoke.main([], platform="cpu", sizes=SMALL, cards=[CARD]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2] == CARD
    last = json.loads(out[-1])
    dev = jax.devices()[0]
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": dev.device_kind,
        "count": len(jax.devices())}}
    assert sum(ln.startswith("phase ") for ln in out) == 6


def test_lambda_min_matches_dense_spectrum():
    from poissbox_tpu.solvers.mg import _dense_periodic_laplacian
    shape, deltas = (4, 6, 8), (0.25, 1 / 6, 0.125)
    ev = np.abs(np.linalg.eigvalsh(_dense_periodic_laplacian(shape, deltas)))
    assert chip_smoke.lambda_min(shape, deltas) == pytest.approx(
        np.sort(ev)[1], rel=1e-12)


def test_solution_checks_bounds_hold_and_bite():
    """The bounds hold for a loosely solved system and fail for a solution
    that is wrong by a smooth mode (same residual scale, large error)."""
    from poissbox_tpu.mesh import Grid3D
    from poissbox_tpu.ops.stencil import make_laplacian_operator
    from poissbox_tpu.solvers.fft import poisson_solve_fft

    g = Grid3D((16, 16, 16))
    A = make_laplacian_operator(g)
    xe = A.project(g.random(jax.random.PRNGKey(0), jnp.float32))
    b = A(xe)
    x = poisson_solve_fft(b, g.deltas)
    s = chip_smoke.solution_checks(x, b, xe, g.deltas)
    assert s["err_exact"] <= s["tol_exact"] and s["err_fft"] <= s["tol_fft"]
    xs = g.cells(0)[:, None, None] * jnp.ones(g.n)
    bad = x + 0.1 * A.project(jnp.sin(2 * np.pi * xs)).astype(x.dtype)
    s = chip_smoke.solution_checks(bad, b, xe, g.deltas)
    assert s["err_exact"] > 1e-3 * s["xnorm"]
    assert s["rel_res"] > 1e-4                 # the residual gate catches it


@pytest.mark.gpu
def test_phases_on_card(gpu, capsys):
    """On a GPU: every single-card phase at small sizes, as the card run
    does them (JAX_PLATFORMS=cuda pytest -m gpu)."""
    assert chip_smoke.main([], sizes={**SMALL, "stencil": 64,
                                      "mgcg": (64,), "fft": 64,
                                      "compact": 64, "demo": 32}) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"]
