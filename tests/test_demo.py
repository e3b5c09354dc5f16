"""Integration tests: the demo app end-to-end (the reference's
`poissbox_demo` run narrative, reference src/example.f90) and the driver
entry points, on the 8-device CPU mesh."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # for __graft_entry__


class TestDemo:
    @pytest.mark.slow
    def test_demo_end_to_end_mgcg(self, capsys):
        from poissbox_tpu.config import Options
        from poissbox_tpu.demo import run
        res = run(Options(["-n", "16", "-ksp_rtol", "1e-8",
                           "-ksp_converged_reason"]))
        out = capsys.readouterr().out
        assert "DoF distribution" in out and "(sum ok)" in out
        assert "check_lapl" in out
        assert "converged" in out
        assert res.rel_residual < 1e-7 and res.reason > 0

    @pytest.mark.slow
    def test_demo_jacobi_cg(self, capsys):
        from poissbox_tpu.config import Options
        from poissbox_tpu.demo import run
        res = run(Options(["-n", "8", "-pc_type", "jacobi",
                           "-ksp_rtol", "1e-6", "-ksp_max_it", "2000"]))
        assert res.rel_residual < 1e-5

    @pytest.mark.slow
    def test_demo_monitor_output(self, capsys):
        from poissbox_tpu.config import Options
        from poissbox_tpu.demo import run
        run(Options(["-n", "8", "-ksp_monitor"]))
        out = capsys.readouterr().out
        assert "KSP Residual norm" in out


class TestGraftEntry:
    def test_entry_compiles_and_runs(self):
        import __graft_entry__ as g
        fn, args = g.entry()
        x, rnorm, iters = jax.jit(fn)(*args)
        assert np.isfinite(float(rnorm))
        assert int(iters) > 0

    @pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
    @pytest.mark.slow
    def test_dryrun_multichip(self):
        import __graft_entry__ as g
        g.dryrun_multichip(8)
