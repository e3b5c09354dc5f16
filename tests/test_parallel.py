"""Multi-device tests on the forced 8-CPU mesh.

The reference covers its parallel path with runtime self-checks under
mpirun — DoF conservation, ownership ranges, matvec consistency (reference
src/example.f90:92-152, 201-261). Here those invariants are real tests on a
virtual 8-device mesh, plus decomposition unit tests against the reference
README's published DoF split (reference README.md:25-33).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.mesh import Grid3D, make_device_mesh
from poissbox_tpu.ops.stencil import apply_laplacian, make_laplacian_operator
from poissbox_tpu.parallel.decomp import decompose_3d, dof_distribution, owned_boxes
from poissbox_tpu.parallel.dist_stencil import apply_laplacian_sharded
from poissbox_tpu.parallel.halo import halo_pad_local
from poissbox_tpu.solvers import cg
from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner


requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")


class TestDecomp:
    def test_reference_dof_split(self):
        # 64^3 on 3 ranks: 90112/86016/86016 (reference README.md:25-33)
        assert sorted(dof_distribution((64, 64, 64), (3, 1, 1)), reverse=True) \
            == [90112, 86016, 86016]

    def test_exact_divisibility_preferred(self):
        assert decompose_3d(8, (64, 64, 64)) in [(8, 1, 1), (4, 2, 1), (2, 2, 2)]
        px, py, pz = decompose_3d(8, (64, 64, 64))
        assert 64 % px == 0 and 64 % py == 0 and 64 % pz == 0

    def test_lane_axis_kept_whole(self):
        # tie-break prefers not splitting z (the innermost, contiguous axis)
        assert decompose_3d(4, (64, 64, 64))[2] == 1

    def test_owned_boxes_tile_domain(self):
        boxes = owned_boxes((10, 7, 5), (3, 2, 1))
        seen = np.zeros((10, 7, 5), dtype=int)
        for (start, count) in boxes.values():
            xs, ys, zs = start
            xn, yn, zn = count
            seen[xs:xs + xn, ys:ys + yn, zs:zs + zn] += 1
        assert (seen == 1).all()

    def test_dof_conservation(self):
        # check_grid analogue (reference src/example.f90:92-116)
        for pgrid in [(2, 2, 2), (8, 1, 1), (4, 2, 1), (3, 2, 1)]:
            counts = dof_distribution((64, 64, 64), pgrid)
            assert sum(counts) == 64**3


@requires_8
class TestHaloExchange:
    @pytest.mark.parametrize("pgrid", [(8, 1, 1), (4, 2, 1), (2, 2, 2)])
    def test_halo_pad_matches_global_wrap(self, pgrid):
        mesh = make_device_mesh(pgrid)
        grid = Grid3D((16, 16, 16), mesh=mesh)
        key = jax.random.PRNGKey(0)
        u = jax.random.normal(key, grid.n, jnp.float64)
        names = list(grid.spec) + [None] * (3 - len(grid.spec))

        from functools import partial

        @partial(jax.shard_map, mesh=mesh, in_specs=grid.spec,
                 out_specs=grid.spec)
        def center_of_pad(block):
            padded = halo_pad_local(block, mesh, names, width=1)
            return padded[1:-1, 1:-1, 1:-1]

        out = center_of_pad(grid.shard(u))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(u))

    @pytest.mark.parametrize("pgrid", [(8, 1, 1), (2, 2, 2)])
    def test_width2_halo(self, pgrid):
        mesh = make_device_mesh(pgrid)
        grid = Grid3D((16, 16, 16), mesh=mesh)
        u = jnp.arange(16**3, dtype=jnp.float64).reshape(16, 16, 16)
        names = list(grid.spec) + [None] * (3 - len(grid.spec))

        from functools import partial

        @partial(jax.shard_map, mesh=mesh, in_specs=grid.spec,
                 out_specs=grid.spec)
        def lapl_w2(block):
            padded = halo_pad_local(block, mesh, names, width=2)
            return padded[2:-2, 2:-2, 2:-2]

        out = lapl_w2(grid.shard(u))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(u))


@requires_8
class TestShardedOperator:
    @pytest.mark.parametrize("pgrid", [(8, 1, 1), (4, 2, 1), (2, 2, 2)])
    def test_explicit_matches_unsharded(self, pgrid):
        # check_lapl analogue across the mesh (reference example.f90:201-233)
        mesh = make_device_mesh(pgrid)
        grid = Grid3D((16, 16, 16), mesh=mesh)
        key = jax.random.PRNGKey(1)
        u = jax.random.normal(key, grid.n, jnp.float64)
        expect = np.asarray(apply_laplacian(u, grid.deltas))
        got = np.asarray(apply_laplacian_sharded(grid.shard(u), grid))
        np.testing.assert_allclose(got, expect, rtol=1e-13, atol=1e-10)

    @pytest.mark.parametrize("pgrid", [(8, 1, 1), (4, 2, 1), (2, 2, 2)])
    def test_overlap_matches_unsharded(self, pgrid):
        # correction-form overlapped exchange == padded exchange == global
        mesh = make_device_mesh(pgrid)
        grid = Grid3D((16, 16, 16), mesh=mesh)
        key = jax.random.PRNGKey(7)
        u = jax.random.normal(key, grid.n, jnp.float64)
        expect = np.asarray(apply_laplacian(u, grid.deltas))
        got = np.asarray(jax.jit(
            lambda v: apply_laplacian_sharded(v, grid, overlap=True))(
            grid.shard(u)))
        np.testing.assert_allclose(got, expect, rtol=1e-13, atol=1e-10)

    def test_gspmd_matches_unsharded(self):
        mesh = make_device_mesh((4, 2, 1))
        grid = Grid3D((16, 16, 16), mesh=mesh)
        key = jax.random.PRNGKey(2)
        u = jax.random.normal(key, grid.n, jnp.float64)
        expect = np.asarray(apply_laplacian(u, grid.deltas))
        us = grid.shard(u)
        got = np.asarray(jax.jit(lambda v: apply_laplacian(v, grid.deltas))(us))
        np.testing.assert_allclose(got, expect, rtol=1e-13, atol=1e-10)


@requires_8
class TestShardedSolve:
    def test_cg_sharded_matches_unsharded(self):
        n = 16
        grid_s = Grid3D((n, n, n)).with_mesh()
        grid_u = Grid3D((n, n, n))
        A_s = make_laplacian_operator(grid_s)
        A_u = make_laplacian_operator(grid_u)
        key = jax.random.PRNGKey(3)
        x_exact = A_u.project(jax.random.normal(key, grid_u.n, jnp.float64))
        b = A_u(x_exact)
        res_u = cg(A_u, b, rtol=1e-10, max_it=2000)
        res_s = jax.jit(lambda bb: cg(A_s, bb, rtol=1e-10, max_it=2000))(
            grid_s.shard(b))
        assert bool(res_s.converged)
        np.testing.assert_allclose(np.asarray(res_s.x), np.asarray(res_u.x),
                                   rtol=1e-6, atol=1e-8)

    @pytest.mark.slow
    def test_mgcg_sharded_converges(self):
        n = 32
        grid = Grid3D((n, n, n)).with_mesh()
        A = make_laplacian_operator(grid)
        M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig())
        key = jax.random.PRNGKey(4)
        u = A.project(grid.random(key))
        b = A(u)
        res = jax.jit(lambda bb: cg(A, bb, M=M, rtol=1e-8, max_it=50))(b)
        assert bool(res.converged)
        assert int(res.iterations) <= 12
        err = float(jnp.linalg.norm((res.x - u).ravel()))
        assert err < 1e-6
