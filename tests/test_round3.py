"""Round-3 behaviors: `-options_left`, size-aware sweep unification across
entry points, pipecg options parity, and live `-ksp_monitor` streaming.

Reference semantics being matched:
  * PETSc options DB complains about set-but-unused options
    (`-options_left`; the reference wires every object through the DB,
    reference src/poissbox.f90:295) — a typo like `-mg_cylce w` must fail
    loudly instead of silently no-op'ing.
  * One solver of record (reference README.md:42-47): the options entry
    point and the MGConfig() default path must build the SAME cycle.
  * `-ksp_monitor` prints residuals *while* KSPSolve runs (reference
    README.md:48-49).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.config import Options, SolverOptions
from poissbox_tpu.linops import LinearOperator
from poissbox_tpu.mesh import Grid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator
from poissbox_tpu.solvers.ksp import make_preconditioner, make_solver, solve


def _identity_op():
    return LinearOperator(apply=lambda x: x,
                          diagonal=lambda: jnp.asarray(1.0))


class TestOptionsLeft:
    def test_typo_fails_loudly(self):
        # `-mg_cylce w` (typo of -mg_cycle) must not be a silent no-op
        opts = Options(["-ksp_type", "cg", "-pc_type", "none",
                        "-mg_cylce", "w"])
        SolverOptions.from_options(opts)  # consumes the legit keys
        assert opts.unused_keys() == ["mg_cylce"]
        with pytest.raises(ValueError, match="mg_cylce"):
            opts.check_unused(error=True)

    def test_clean_run_is_silent(self):
        opts = Options(["-ksp_type", "cg", "-ksp_rtol", "1e-7"])
        SolverOptions.from_options(opts)
        assert opts.unused_keys() == []
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            opts.check_unused()  # must not warn

    def test_unused_warns_by_default(self):
        opts = Options(["-ksp_typo", "cg"])
        with pytest.warns(UserWarning, match="ksp_typo"):
            opts.check_unused()

    def test_error_flag_read_from_db(self):
        opts = Options(["-bogus_flag", "-options_error_if_unused"])
        with pytest.raises(ValueError, match="bogus_flag"):
            opts.check_unused()

    def test_ksp_solve_options_left(self):
        # `solve()` with `-options_left` warns about the unconsumed typo
        grid = Grid3D((8, 8, 8))
        A = make_laplacian_operator(grid)
        b = A(A.project(jax.random.normal(jax.random.PRNGKey(2), grid.n,
                                          jnp.float64)))
        opts = Options(["-ksp_type", "cg", "-pc_type", "jacobi",
                        "-ksp_rtol", "1e-6", "-mg_cylce", "w",
                        "-options_left"])
        with pytest.warns(UserWarning, match="mg_cylce"):
            solve(A, b, opts, shape=grid.n, deltas=grid.deltas)

    def test_log_view(self, capsys):
        grid = Grid3D((8, 8, 8))
        A = make_laplacian_operator(grid)
        b = A(A.project(jax.random.normal(jax.random.PRNGKey(4), grid.n,
                                          jnp.float64)))
        solve(A, b, Options(["-ksp_type", "cg", "-pc_type", "jacobi",
                             "-ksp_rtol", "1e-6", "-log_view"]),
              shape=grid.n, deltas=grid.deltas)
        out = capsys.readouterr().out
        assert "log_view:   setup" in out and "log_view:   solve" in out
        assert "iterations" in out
        # round 5: PETSc-style per-event table (count, time/call, total, %)
        assert "log_view:   MatMult" in out
        assert "log_view:   PCApply" in out
        assert "time/call" in out

    @pytest.mark.slow
    def test_demo_errors_on_typo(self):
        # jacobi keeps the run cheap — the options-left check fires either
        # way, after the solve completes
        from poissbox_tpu import demo
        with pytest.raises(ValueError, match="mg_cylce"):
            demo.run(Options(["-n", "16", "-pc_type", "jacobi",
                              "-ksp_rtol", "1e-4", "-mg_cylce", "w",
                              "-options_error_if_unused"]))


class TestSweepPolicyUnified:
    """With neither -mg_levels_ksp_rtol nor
    -mg_levels_ksp_max_it set, the options entry point must resolve the
    same size-aware sweep counts as MGConfig() (solvers.mg._resolve_sweeps):
    V(3,3) at 256^3-class, V(2,2) at 512^3-class."""

    def _cfg_for(self, shape, flags=()):
        opts = SolverOptions.from_options(Options(["-pc_type", "mg", *flags]))
        A = _identity_op()
        deltas = tuple(1.0 / s for s in shape)
        M = make_preconditioner(A, opts, shape, deltas, jnp.float64)
        return M.config

    def test_auto_matches_mgconfig_512(self):
        from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner
        shape = (512, 512, 512)
        cfg_opts = self._cfg_for(shape)
        M_direct = make_mg_preconditioner(shape, (1 / 512,) * 3, MGConfig(),
                                          dtype=jnp.float64)
        assert cfg_opts.pre_smooth == M_direct.config.pre_smooth == 1
        assert cfg_opts.post_smooth == M_direct.config.post_smooth == 1

    def test_auto_256_class(self):
        cfg = self._cfg_for((256, 256, 256))
        assert (cfg.pre_smooth, cfg.post_smooth) == (2, 2)

    def test_auto_matches_mgconfig_64(self):
        cfg = self._cfg_for((64, 64, 64))
        assert (cfg.pre_smooth, cfg.post_smooth) == (3, 3)

    def test_explicit_flags_keep_calibrated_path(self):
        from poissbox_tpu.solvers.mg import sweeps_for_level_rtol
        cfg = self._cfg_for((512, 512, 512),
                            ["-mg_levels_ksp_rtol", "1e-8",
                             "-mg_levels_ksp_max_it", "30"])
        assert cfg.pre_smooth == sweeps_for_level_rtol("sor", 1e-8, 30) > 2

    def test_max_it_alone_binds(self):
        cfg = self._cfg_for((64, 64, 64), ["-mg_levels_ksp_max_it", "1"])
        assert cfg.pre_smooth == 1


class TestPipecgParity:
    def _problem(self):
        grid = Grid3D((16, 16, 16))
        A = make_laplacian_operator(grid)
        x = A.project(jax.random.normal(jax.random.PRNGKey(5), grid.n,
                                        jnp.float64))
        return grid, A, A(x), x

    def test_natural_norm_converges(self):
        from poissbox_tpu.solvers.pipecg import pipecg
        grid, A, b, x_exact = self._problem()
        inv_diag = 1.0 / A.diagonal()
        res = pipecg(A, b, M=lambda r: inv_diag * r, rtol=1e-10, max_it=200,
                     norm_type="natural")
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_exact),
                                   rtol=1e-7, atol=1e-9)

    def test_cg_natural_norm_negative_definite(self):
        # regression: <r, M r> is NEGATIVE on this sign-consistent
        # negative-definite pair; a clamped sqrt(max(.,0)) reported 0 and
        # stalled the solve at x=0 without iterating
        from poissbox_tpu.solvers.cg import cg
        grid, A, b, x_exact = self._problem()
        inv_diag = 1.0 / A.diagonal()
        res = cg(A, b, M=lambda r: inv_diag * r, rtol=1e-10, max_it=200,
                 norm_type="natural")
        assert bool(res.converged) and int(res.iterations) > 0
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_exact),
                                   rtol=1e-7, atol=1e-9)

    def test_bad_norm_type_rejected(self):
        from poissbox_tpu.solvers.pipecg import pipecg
        _, A, b, _ = self._problem()
        with pytest.raises(ValueError, match="norm_type"):
            pipecg(A, b, norm_type="preconditioned")

    def test_norm_type_flag_dispatches(self):
        grid, A, b, x_exact = self._problem()
        o = SolverOptions(ksp_type="pipecg", ksp_norm_type="natural",
                          pc_type="jacobi", ksp_rtol=1e-10, ksp_max_it=200)
        res = make_solver(A, o, grid.n, grid.deltas)(b)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_exact),
                                   rtol=1e-7, atol=1e-9)

    @pytest.mark.parametrize("ksp_type,should_warn", [
        ("cg", True), ("pipecg", True), ("fcg", False)])
    def test_bf16_warning_matrix(self, ksp_type, should_warn):
        # bf16 V-cycle noise stalls the Fletcher-Reeves recurrence of both
        # cg and pipecg; only fcg's Polak-Ribiere beta is exempt
        A = _identity_op()
        o = SolverOptions(ksp_type=ksp_type, pc_type="mg", ksp_rtol=1e-8,
                          mg_cycle_dtype="bfloat16")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            make_preconditioner(A, o, (16, 16, 16), (1 / 16,) * 3)
        stall = [w for w in caught if "bf16" in str(w.message)]
        assert bool(stall) == should_warn

    @pytest.mark.parametrize("ksp_type", ["cg", "pipecg", "fcg"])
    def test_f32_cycle_no_warning(self, ksp_type):
        A = _identity_op()
        o = SolverOptions(ksp_type=ksp_type, pc_type="mg", ksp_rtol=1e-8,
                          mg_cycle_dtype="float32")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            make_preconditioner(A, o, (16, 16, 16), (1 / 16,) * 3)
        assert not [w for w in caught if "bf16" in str(w.message)]


class TestCensusParser:
    """utils.census HLO parsing — unit-level (the compiled-program
    assertion lives in tests/test_scaling_model.py)."""

    HLO = """\
HloModule jit_f, entry_computation_layout={...}

%wide.body_spmd (p: f32[8,16]) -> f32[8,16] {
  %ar = f32[] all-reduce(f32[] %x), channel_id=1, to_apply=%sum
  %cps = (f32[1,16]{1,0:T(8,128)S(1)}, f32[1,16]{1,0}, u32[]{:S(2)}, u32[]{:S(2)}) collective-permute-start(%slice.1), channel_id=2
  %cpd = f32[1,16]{1,0} collective-permute-done(%cps)
}

ENTRY %main_spmd (arg: f32[8,16]) -> f32[8,16] {
  %a2a = f32[8,16]{1,0} all-to-all(%arg), channel_id=3
  %ag = f32[64,16]{1,0} all-gather(%arg), channel_id=4, dimensions={0}
  %w = f32[8,16]{1,0} while(%arg), condition=%cond.1, body=%wide.body_spmd
}
"""

    def test_counts_and_bytes(self):
        from poissbox_tpu.utils.census import census
        got = census(self.HLO)
        assert got["all-to-all"] == {"count": 1, "bytes": 8 * 16 * 4}
        assert got["all-gather"] == {"count": 1, "bytes": 64 * 16 * 4}
        assert got["all-reduce"] == {"count": 1, "bytes": 4}
        # async permute: counted once (start), payload = ONE buffer,
        # u32 context scalars ignored
        assert got["collective-permute"] == {"count": 1, "bytes": 16 * 4}

    def test_computation_scoping_and_while_body(self):
        from poissbox_tpu.utils.census import census, while_bodies
        assert while_bodies(self.HLO) == ["wide.body_spmd"]
        body = census(self.HLO, computation="wide.body_spmd")
        assert set(body) == {"all-reduce", "collective-permute"}
        main = census(self.HLO, computation="main_spmd")
        assert set(main) == {"all-to-all", "all-gather"}

    def test_max_gather_bytes(self):
        from poissbox_tpu.utils.census import max_gather_bytes
        assert max_gather_bytes(self.HLO) == 64 * 16 * 4

    def test_halo_model_counts(self):
        from poissbox_tpu.mesh import Grid3D
        from poissbox_tpu.utils.census import halo_model
        grid = Grid3D((16, 16, 16)).with_mesh()
        if grid.mesh is None:
            pytest.skip("needs a multi-device mesh")
        from poissbox_tpu.parallel.dist_stencil import local_shape
        loc = local_shape(grid)
        want = halo_model(grid, itemsize=8)
        # 2 permutes per sharded dim, one face plane each
        n_ax = sum(1 for d, n in enumerate(grid.n)
                   if loc[d] != n)
        assert want["count"] == 2 * n_ax



class TestLiveMonitor:
    """Residual lines must appear DURING a jitted solve,
    not from post-hoc history rendering."""

    def _problem(self):
        grid = Grid3D((16, 16, 16))
        A = make_laplacian_operator(grid)
        x = A.project(jax.random.normal(jax.random.PRNGKey(7), grid.n,
                                        jnp.float64))
        return A, A(x)

    @pytest.mark.parametrize("ksp_type", ["cg", "fcg", "pipecg"])
    def test_streams_inside_jit(self, ksp_type, capfd):
        A, b = self._problem()
        o = SolverOptions(ksp_type=ksp_type, pc_type="jacobi",
                          ksp_rtol=1e-8, ksp_max_it=100, ksp_monitor=True)
        slv = jax.jit(lambda bb: make_solver(A, o, b.shape,
                                             (1 / 16,) * 3)(bb).x)
        jax.block_until_ready(slv(b))
        jax.effects_barrier()
        out = capfd.readouterr().out
        lines = [ln for ln in out.splitlines() if "KSP Residual norm" in ln]
        assert len(lines) >= 3, out
        # iteration counters present and starting at 0
        assert lines[0].split()[0] == "0"
        # the streamed norms are real decreasing residuals
        norms = [float(ln.split()[-1]) for ln in lines]
        assert norms[-1] < norms[0] * 1e-6

    def test_solve_does_not_duplicate(self, capfd):
        A, b = self._problem()
        opts = Options(["-ksp_type", "cg", "-pc_type", "jacobi",
                        "-ksp_rtol", "1e-8", "-ksp_max_it", "100",
                        "-ksp_monitor"])
        res = solve(A, b, opts, shape=b.shape, deltas=(1 / 16,) * 3)
        jax.block_until_ready(res.x)
        jax.effects_barrier()
        out = capfd.readouterr().out
        lines = [ln for ln in out.splitlines() if "KSP Residual norm" in ln]
        starts = [ln.split()[0] for ln in lines]
        assert len(starts) == len(set(starts)), "duplicated monitor lines"

    def test_off_by_default(self, capfd):
        A, b = self._problem()
        o = SolverOptions(ksp_type="cg", pc_type="jacobi", ksp_rtol=1e-8,
                          ksp_max_it=100)
        jax.block_until_ready(
            make_solver(A, o, b.shape, (1 / 16,) * 3)(b).x)
        jax.effects_barrier()
        assert "KSP Residual norm" not in capfd.readouterr().out
