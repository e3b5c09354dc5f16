"""Tests for the auxiliary subsystems (profiling/logging/debugging)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.utils import check_field, is_process0, kernel_time, log0
from poissbox_tpu.utils.profiling import bandwidth_gbps


class TestDebugging:
    def test_check_field_passes(self):
        f = jnp.ones((4, 4))
        assert check_field(f, shape=(4, 4), dtype=f.dtype) is f

    def test_check_field_shape_mismatch(self):
        with pytest.raises(ValueError, match="shape"):
            check_field(jnp.ones((4, 4)), shape=(8, 8))

    def test_check_field_nan(self):
        with pytest.raises(FloatingPointError, match="NaN"):
            check_field(jnp.asarray([1.0, jnp.nan]))

    def test_check_field_dtype(self):
        with pytest.raises(TypeError, match="dtype"):
            check_field(jnp.ones(3, jnp.float32), dtype=jnp.float64)


class TestLogging:
    def test_process0(self, capsys):
        assert is_process0()  # single-process test env
        log0("hello", 42)
        assert capsys.readouterr().out == "hello 42\n"

    def test_all_processes_prefix(self, capsys):
        log0("x", all_processes=True)
        assert capsys.readouterr().out.startswith("[p0]")


class TestProfiling:
    def test_kernel_time_positive_and_sane(self):
        f = lambda v: v * 2.0 + 1.0
        t = kernel_time(f, jnp.ones((64, 64)), reps=1)
        assert 0 < t < 1.0

    def test_bandwidth_positive(self):
        gb = bandwidth_gbps(lambda v: v + 1.0, jnp.ones((128, 128)), reps=1)
        assert gb > 0


def test_ksp_view_prints_resolved_configuration(capsys):
    # `-ksp_view` (round 4): the assembled solver configuration with the
    # RESOLVED MG cycle (auto sweep counts + level stack), printed before
    # the solve like PETSc's KSPView
    import jax.numpy as jnp

    from poissbox_tpu.config import Options
    from poissbox_tpu.mesh import Grid3D
    from poissbox_tpu.ops.stencil import make_laplacian_operator
    from poissbox_tpu.solvers.ksp import solve

    g = Grid3D((16, 16, 16))
    A = make_laplacian_operator(g)
    b = A.project(jnp.ones(g.n).at[0, 0, 0].set(2.0))
    solve(A, b, Options(["-ksp_type", "cg", "-pc_type", "mg",
                         "-ksp_rtol", "1e-6", "-ksp_view"]),
          shape=g.n, deltas=g.deltas)
    out = capsys.readouterr().out
    assert "KSP Object:" in out and "type: cg" in out
    assert "cycle: V(3,3)" in out          # resolved auto sweeps at 16^3
    assert "16x16x16 -> 8x8x8 -> 4x4x4" in out
    assert "coarse solve: svd" in out


class TestCompileCache:
    def test_env_var_honoured(self, monkeypatch, tmp_path):
        from poissbox_tpu.utils.compile_cache import setup_compile_cache
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert setup_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; nothing is set in code
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_path_in_checkout(self, monkeypatch):
        import pathlib

        from poissbox_tpu.utils import compile_cache
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = pathlib.Path(__file__).resolve().parents[1]
        prev = jax.config.jax_compilation_cache_dir
        try:
            path = compile_cache.setup_compile_cache()
            assert path == str(root / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", prev)
        ignored = (root / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored


def _dot_precisions(jaxpr) -> list:
    """Precision config of every dot_general in a jaxpr, sub-jaxprs
    (loops, conditionals) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out += _dot_precisions(inner)
    return out


class TestMatmulPrecision:
    """f32 contractions that decide accuracy ask for HIGHEST precision (a
    GPU may otherwise run them in TF32)."""

    HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)

    def test_mg_coarse_solve(self):
        from poissbox_tpu.solvers.mg import (
            MGConfig,
            _build_levels,
            _coarse_pinv,
            v_cycle,
        )
        cfg = MGConfig(pre_smooth=1, post_smooth=1)
        levels = _build_levels((8, 8, 8), (0.125,) * 3, cfg)
        pinv = _coarse_pinv(levels[-1], cfg, jnp.float32)
        r = jnp.ones((8, 8, 8), jnp.float32)
        jaxpr = jax.make_jaxpr(lambda v: v_cycle(levels, pinv, cfg, v))(r)
        precs = _dot_precisions(jaxpr.jaxpr)
        assert precs and all(p == self.HIGHEST for p in precs), precs

    def test_gmres_arnoldi(self):
        from poissbox_tpu.mesh import Grid3D
        from poissbox_tpu.ops.stencil import make_laplacian_operator
        from poissbox_tpu.solvers.gmres import gmres
        A = make_laplacian_operator(Grid3D((8, 8, 8)))
        b = jnp.ones((8, 8, 8), jnp.float32)
        jaxpr = jax.make_jaxpr(
            lambda v: gmres(A, v, restart=4, max_it=8).x)(b)
        precs = _dot_precisions(jaxpr.jaxpr)
        assert len(precs) >= 3 and all(p == self.HIGHEST for p in precs), precs
