"""Distributed (shard_map + ppermute) operator and MG tests on the 8-CPU mesh.

Round-2 coverage for the multi-chip production path: every correction-form
sharded operation must match its single-device formulation exactly (the
reference's matvec-consistency self-check methodology, reference
src/example.f90:201-261, applied to the distributed smoothers as well), and
the mesh-aware MG preconditioner must agree with the unsharded V-cycle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.mesh import Grid3D, make_device_mesh
from poissbox_tpu.ops.stencil import apply_laplacian, default_impl, make_laplacian_operator
from poissbox_tpu.parallel.dist_stencil import (
    apply_laplacian_dot_sharded,
    jacobi_sweep_sharded,
    residual_sharded,
    sor_parity_local_ok,
    sor_sweep_sharded,
)
from poissbox_tpu.solvers.cg import cg
from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner, sweeps_for_level_rtol

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")

PGRIDS = [(8, 1, 1), (4, 2, 1), (2, 2, 2)]


def _grid(pgrid, n=16):
    mesh = make_device_mesh(pgrid)
    return Grid3D((n, n, n), mesh=mesh)


def _field(grid, seed=0):
    u = jax.random.normal(jax.random.PRNGKey(seed), grid.n, jnp.float64)
    return grid.shard(u)


class TestImplSelection:
    def test_default_impl_dist_on_mesh(self):
        mesh = make_device_mesh((8, 1, 1))
        assert default_impl(mesh) == "dist"
        assert default_impl(None) == "roll"


    def test_sor_parity_local_ok(self):
        assert sor_parity_local_ok(_grid((8, 1, 1), 16))       # local 2 even
        assert not sor_parity_local_ok(_grid((8, 1, 1), 24))   # local 3 odd
        with pytest.raises(ValueError):
            g = _grid((8, 1, 1), 24)
            sor_sweep_sharded(_field(g), _field(g, 1), g, 1.0, 0)


@requires_8
class TestDistOps:
    @pytest.mark.parametrize("pgrid", PGRIDS)
    def test_residual_matches(self, pgrid):
        grid = _grid(pgrid)
        x, b = _field(grid, 1), _field(grid, 2)
        want = np.asarray(b - apply_laplacian(x, grid.deltas))
        got = np.asarray(jax.jit(
            lambda xx, bb: residual_sharded(xx, bb, grid))(x, b))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-10)

    @pytest.mark.parametrize("pgrid", PGRIDS)
    def test_jacobi_sweep_matches(self, pgrid):
        grid = _grid(pgrid)
        x, b = _field(grid, 3), _field(grid, 4)
        w = 8.0 / 9.0
        diag = -2.0 * sum(1.0 / d**2 for d in grid.deltas)
        want = np.asarray(x + (w / diag) * (b - apply_laplacian(x, grid.deltas)))
        got = np.asarray(jax.jit(
            lambda xx, bb: jacobi_sweep_sharded(xx, bb, grid, w))(x, b))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)

    @pytest.mark.parametrize("pgrid", PGRIDS)
    @pytest.mark.parametrize("color", [0, 1])
    def test_sor_color_matches(self, pgrid, color):
        grid = _grid(pgrid)
        x, b = _field(grid, 5), _field(grid, 6)
        diag = -2.0 * sum(1.0 / d**2 for d in grid.deltas)
        ii, jj, kk = jnp.meshgrid(*(jnp.arange(n) for n in grid.n),
                                  indexing="ij")
        mask = (((ii + jj + kk) % 2) == color).astype(x.dtype)
        want = np.asarray(
            x + (1.0 / diag) * mask * (b - apply_laplacian(x, grid.deltas)))
        got = np.asarray(jax.jit(
            lambda xx, bb: sor_sweep_sharded(xx, bb, grid, 1.0, color))(x, b))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)

    @pytest.mark.parametrize("pgrid", PGRIDS)
    def test_apply_dot_matches(self, pgrid):
        grid = _grid(pgrid)
        u = _field(grid, 7)
        want_out = np.asarray(apply_laplacian(u, grid.deltas))
        want_dot = float(jnp.sum(u * apply_laplacian(u, grid.deltas)))
        out, dot = jax.jit(lambda v: apply_laplacian_dot_sharded(v, grid))(u)
        np.testing.assert_allclose(np.asarray(out), want_out,
                                   rtol=1e-13, atol=1e-10)
        assert abs(float(dot) - want_dot) <= 1e-10 * abs(want_dot)


@requires_8
class TestDistMG:
    @pytest.mark.parametrize("pgrid", PGRIDS)
    def test_vcycle_matches_unsharded(self, pgrid):
        n = 32
        mesh = make_device_mesh(pgrid)
        grid_s = Grid3D((n, n, n), mesh=mesh)
        grid_u = Grid3D((n, n, n))
        cfg = MGConfig()
        M_u = make_mg_preconditioner(grid_u.n, grid_u.deltas, cfg)
        M_s = make_mg_preconditioner(grid_s.n, grid_s.deltas, cfg,
                                     grid=grid_s)
        r = jax.random.normal(jax.random.PRNGKey(9), grid_u.n, jnp.float64)
        r = r - jnp.mean(r)
        want = np.asarray(M_u(r))
        got = np.asarray(jax.jit(M_s)(grid_s.shard(r)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)

    def test_dist_levels_built(self):
        from poissbox_tpu.solvers.mg import _build_levels
        grid = _grid((4, 2, 1), 32)
        levels = _build_levels((32, 32, 32), grid.deltas, MGConfig(),
                               grid=grid)
        # 32 -> local 8 even (dist), 16 -> local 4 even (dist),
        # 8 -> local 2 even (dist), 4 -> local 1 odd (replicated)
        dist_flags = [lvl.grid is not None for lvl in levels]
        assert dist_flags == [True, True, True, False]
        assert all(lvl.mesh is not None for lvl in levels)

    @pytest.mark.slow
    def test_mgcg_dist_matches_unsharded_solution(self):
        n = 32
        grid_s = Grid3D((n, n, n)).with_mesh()
        grid_u = Grid3D((n, n, n))
        A_s = make_laplacian_operator(grid_s)   # auto -> dist
        A_u = make_laplacian_operator(grid_u)
        M_s = make_mg_preconditioner(grid_s.n, grid_s.deltas, MGConfig(),
                                     grid=grid_s)
        M_u = make_mg_preconditioner(grid_u.n, grid_u.deltas, MGConfig())
        x_exact = A_u.project(
            jax.random.normal(jax.random.PRNGKey(10), grid_u.n, jnp.float64))
        b = A_u(x_exact)
        res_u = cg(A_u, b, M=M_u, rtol=1e-10, max_it=50)
        res_s = jax.jit(lambda bb: cg(A_s, bb, M=M_s, rtol=1e-10,
                                      max_it=50))(grid_s.shard(b))
        assert bool(res_s.converged)
        assert abs(int(res_s.iterations) - int(res_u.iterations)) <= 1
        np.testing.assert_allclose(np.asarray(res_s.x), np.asarray(res_u.x),
                                   rtol=1e-6, atol=1e-9)


class TestLevelRtolSemantics:
    def test_rtol_changes_sweeps(self):
        # the flag must change behavior: looser rtol ->
        # fewer sweeps, capped by max_it
        loose = sweeps_for_level_rtol("sor", 1e-2, 30)
        tight = sweeps_for_level_rtol("sor", 1e-8, 30)
        assert loose < tight
        assert sweeps_for_level_rtol("sor", 1e-20, 3) == 3  # max_it binds
        # the reference's flag set of record: rtol 1e-4, max_it 2 -> 2
        assert sweeps_for_level_rtol("sor", 1e-4, 2) == 2

    def test_solver_options_consume_flag(self):
        from poissbox_tpu.config import Options, SolverOptions
        from poissbox_tpu.solvers.ksp import make_preconditioner
        from poissbox_tpu.linops import LinearOperator

        A = LinearOperator(apply=lambda x: x, diagonal=lambda: jnp.asarray(1.0))
        got = {}

        import poissbox_tpu.solvers.ksp as ksp_mod
        orig = ksp_mod.make_mg_preconditioner

        def spy(shape, deltas, cfg, dtype, grid=None):
            got["cfg"] = cfg
            return orig(shape, deltas, cfg, dtype, grid=grid)

        ksp_mod.make_mg_preconditioner = spy
        try:
            o = SolverOptions.from_options(Options(
                ["-pc_type", "mg", "-mg_levels_ksp_rtol", "1e-8",
                 "-mg_levels_ksp_max_it", "30"]))
            make_preconditioner(A, o, (16, 16, 16), (1 / 16,) * 3)
        finally:
            ksp_mod.make_mg_preconditioner = orig
        assert got["cfg"].pre_smooth == sweeps_for_level_rtol("sor", 1e-8, 30)
        assert got["cfg"].pre_smooth > 2
