"""Geometric-multigrid tests.

The reference's MG coverage is indirect — GAMG is configured by flags and
observed through `-ksp_monitor` convergence (reference README.md:42-49).
Here the V-cycle is a first-class object, so its algebraic requirements are
tested directly: transfer-operator invariants, smoother behavior, V-cycle
symmetry + linearity (required for CG preconditioning), contraction, and
MG-CG iteration counts on the 64^3 demo problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import rms

from poissbox_tpu.mesh import Grid3D
from poissbox_tpu.ops.stencil import apply_laplacian, make_laplacian_operator
from poissbox_tpu.solvers import cg
from poissbox_tpu.solvers.mg import (
    MGConfig,
    _build_levels,
    _dense_periodic_laplacian,
    make_mg_preconditioner,
    prolong,
    restrict,
)


class TestTransfers:
    def test_restrict_preserves_constants_and_mean(self):
        f = jnp.full((8, 8, 8), 3.25)
        c = restrict(f)
        assert c.shape == (4, 4, 4)
        np.testing.assert_allclose(np.asarray(c), 3.25)
        key = jax.random.PRNGKey(1)
        f = jax.random.uniform(key, (8, 8, 8), jnp.float64)
        assert abs(float(jnp.mean(restrict(f)) - jnp.mean(f))) < 1e-14

    def test_prolong_preserves_constants_and_mean(self):
        c = jnp.full((4, 4, 4), -1.5)
        f = prolong(c)
        assert f.shape == (8, 8, 8)
        np.testing.assert_allclose(np.asarray(f), -1.5)
        key = jax.random.PRNGKey(2)
        c = jax.random.uniform(key, (4, 4, 4), jnp.float64)
        assert abs(float(jnp.mean(prolong(c)) - jnp.mean(c))) < 1e-14


    def test_prolong_restrict_adjoint(self):
        # <P c, f>_fine = 8 <c, R f>_coarse for these cell-centered
        # transfers (R = P^T / 8): the Galerkin-compatibility condition.
        kc, kf = jax.random.split(jax.random.PRNGKey(3))
        c = jax.random.normal(kc, (4, 4, 4), jnp.float64)
        f = jax.random.normal(kf, (8, 8, 8), jnp.float64)
        lhs = float(jnp.sum(prolong(c) * f))
        rhs = 8.0 * float(jnp.sum(c * restrict(f)))
        assert abs(lhs - rhs) < 1e-11 * max(1.0, abs(lhs))


class TestCoarseOperator:
    def test_dense_matches_matrix_free(self):
        shape, deltas = (4, 4, 4), (0.25, 0.25, 0.25)
        A = _dense_periodic_laplacian(shape, deltas)
        key = jax.random.PRNGKey(4)
        u = jax.random.normal(key, shape, jnp.float64)
        dense = (A @ np.asarray(u).ravel()).reshape(shape)
        free = np.asarray(apply_laplacian(u, deltas))
        np.testing.assert_allclose(dense, free, rtol=1e-12, atol=1e-10)

    def test_dense_is_singular_with_constant_nullspace(self):
        A = _dense_periodic_laplacian((4, 4, 4), (0.25, 0.25, 0.25))
        ones = np.ones(64)
        assert np.max(np.abs(A @ ones)) < 1e-10
        assert np.linalg.matrix_rank(A, tol=1e-8) == 63


class TestVCycle:
    @pytest.fixture(scope="class")
    def setup(self):
        grid = Grid3D((16, 16, 16))
        A = make_laplacian_operator(grid)
        M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig())
        return grid, A, M

    def test_levels_autobuild(self):
        levels = _build_levels((64, 64, 64), (1 / 64,) * 3, MGConfig())
        assert [l.shape[0] for l in levels] == [64, 32, 16, 8, 4]

    def test_symmetry(self, setup):
        # CG needs a symmetric preconditioner; the reversed-color
        # post-smoother makes the V-cycle self-adjoint.
        grid, A, M = setup
        k1, k2 = jax.random.split(jax.random.PRNGKey(5))
        r1 = jax.random.normal(k1, grid.n, jnp.float64)
        r2 = jax.random.normal(k2, grid.n, jnp.float64)
        lhs = float(jnp.sum(M(r1) * r2))
        rhs = float(jnp.sum(r1 * M(r2)))
        assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))

    def test_linearity(self, setup):
        grid, A, M = setup
        k1, k2 = jax.random.split(jax.random.PRNGKey(6))
        r1 = jax.random.normal(k1, grid.n, jnp.float64)
        r2 = jax.random.normal(k2, grid.n, jnp.float64)
        combo = np.asarray(M(2.0 * r1 - 3.0 * r2))
        parts = np.asarray(2.0 * M(r1) - 3.0 * M(r2))
        np.testing.assert_allclose(combo, parts, rtol=1e-10, atol=1e-10)

    def test_contraction(self, setup):
        # One V-cycle must sharply reduce the error of the singular system
        # (mean-free components).
        grid, A, M = setup
        key = jax.random.PRNGKey(7)
        u = A.project(jax.random.normal(key, grid.n, jnp.float64))
        b = A(u)
        x = jnp.zeros_like(b)
        for _ in range(2):
            x = A.project(x + M(b - A(x)))
        e0 = rms(np.asarray(u))
        e2 = rms(np.asarray(x - u))
        assert e2 < 0.05 * e0  # >= 10x error reduction per cycle


class TestWCycle:
    """cycle="w": sub-fine levels revisited twice (S = 2C - C A C per
    child level) — must stay symmetric, converge at least as fast as V,
    and be reachable from the options DB (-mg_cycle w)."""

    def test_symmetry(self):
        grid = Grid3D((16, 16, 16))
        M = make_mg_preconditioner(
            grid.n, grid.deltas,
            MGConfig(cycle="w", pre_smooth=2, post_smooth=2))
        k1, k2 = jax.random.split(jax.random.PRNGKey(15))
        r1 = jax.random.normal(k1, grid.n, jnp.float64)
        r2 = jax.random.normal(k2, grid.n, jnp.float64)
        lhs = float(jnp.sum(M(r1) * r2))
        rhs = float(jnp.sum(r1 * M(r2)))
        assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))

    @pytest.mark.slow
    def test_converges_no_slower_than_v(self):
        grid = Grid3D((32, 32, 32))
        A = make_laplacian_operator(grid)
        u = A.project(jax.random.normal(jax.random.PRNGKey(16), grid.n,
                                        jnp.float64))
        b = A(u)
        kw = dict(pre_smooth=2, post_smooth=2)
        Mv = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(**kw))
        Mw = make_mg_preconditioner(grid.n, grid.deltas,
                                    MGConfig(cycle="w", **kw))
        rv = cg(A, b, M=Mv, rtol=1e-8, max_it=30)
        rw = cg(A, b, M=Mw, rtol=1e-8, max_it=30)
        assert bool(rw.converged)
        assert int(rw.iterations) <= int(rv.iterations)

    def test_options_dispatch(self):
        from poissbox_tpu.config import Options
        from poissbox_tpu.solvers.ksp import solve
        grid = Grid3D((16, 16, 16))
        A = make_laplacian_operator(grid)
        u = A.project(jax.random.normal(jax.random.PRNGKey(17), grid.n,
                                        jnp.float64))
        b = A(u)
        res = solve(A, b, Options(["-pc_type", "mg", "-mg_cycle", "w",
                                   "-ksp_rtol", "1e-9"]),
                    shape=grid.n, deltas=grid.deltas)
        assert bool(res.converged)
        r = float(jnp.linalg.norm((A(res.x) - b).ravel()))
        assert r < 1e-8 * float(jnp.linalg.norm(b.ravel()))

    @pytest.mark.slow
    def test_pre_dtype_low_precision_presmooth(self):
        # bf16 pre-smoothing must not change the cycle's fixed point: the
        # f64 residual absorbs the quantized iterate, so MG-CG converges
        # to the same tolerance in (at most one more) iteration
        grid = Grid3D((32, 32, 32))
        A = make_laplacian_operator(grid)
        u = A.project(jax.random.normal(jax.random.PRNGKey(18), grid.n,
                                        jnp.float64))
        b = A(u)
        Mr = make_mg_preconditioner(grid.n, grid.deltas, MGConfig())
        Mb = make_mg_preconditioner(grid.n, grid.deltas,
                                    MGConfig(pre_dtype="bfloat16"))
        rr = cg(A, b, M=Mr, rtol=1e-10, max_it=30)
        rb = cg(A, b, M=Mb, rtol=1e-10, max_it=30)
        assert bool(rb.converged)
        assert int(rb.iterations) <= int(rr.iterations) + 1
        res = float(jnp.linalg.norm((A(rb.x) - b).ravel()))
        assert res < 1e-9 * float(jnp.linalg.norm(b.ravel()))


    def test_pre_dtype_auto_resolution(self):
        # 512^3-class f32 defaults to the bf16 pre-smooth; explicit
        # "float32" opts out; smaller grids and f64 setups stay untouched
        M512 = make_mg_preconditioner((512,) * 3, (1 / 512.0,) * 3,
                                      MGConfig(), dtype=jnp.float32)
        assert M512.config.pre_dtype == "bfloat16"
        Moff = make_mg_preconditioner((512,) * 3, (1 / 512.0,) * 3,
                                      MGConfig(pre_dtype="float32"),
                                      dtype=jnp.float32)
        assert Moff.config.pre_dtype == "float32"
        M256 = make_mg_preconditioner((256,) * 3, (1 / 256.0,) * 3,
                                      MGConfig(), dtype=jnp.float32)
        assert M256.config.pre_dtype == ""
        M64 = make_mg_preconditioner((512,) * 3, (1 / 512.0,) * 3,
                                     MGConfig(), dtype=jnp.float64)
        assert M64.config.pre_dtype == ""

    def test_unknown_cycle_rejected(self):
        grid = Grid3D((8, 8, 8))
        M = make_mg_preconditioner(grid.n, grid.deltas,
                                   MGConfig(cycle="f"))
        with pytest.raises(ValueError, match="cycle"):
            M(jnp.zeros(grid.n, jnp.float64))



class TestMGCG:
    @pytest.mark.parametrize("smoother", ["sor", "jacobi"])
    def test_mgcg_fast_convergence_16(self, smoother):
        grid = Grid3D((16, 16, 16))
        A = make_laplacian_operator(grid)
        M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(smoother=smoother))
        key = jax.random.PRNGKey(8)
        u = A.project(grid.random(key))
        b = A(u)
        res = cg(A, b, M=M, rtol=1e-8, max_it=50)
        assert bool(res.converged)
        assert int(res.iterations) <= 12
        assert rms(np.asarray(res.x - u)) < 1e-7

    @pytest.mark.slow
    def test_mgcg_64_demo_problem(self):
        # the reference demo's 64^3 problem with its solver of record:
        # CG + multigrid, random mean-free solution, rtol 1e-8
        grid = Grid3D((64, 64, 64))
        A = make_laplacian_operator(grid)
        M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig())
        key = jax.random.PRNGKey(9)
        u = A.project(grid.random(key))
        b = A(u)
        res = jax.jit(lambda b_: cg(A, b_, M=M, rtol=1e-8, max_it=50))(b)
        assert bool(res.converged)
        # GAMG-CG converges in O(10) iterations on this problem; GMG must too
        assert int(res.iterations) <= 15
        true_res = float(jnp.linalg.norm((A(res.x) - b).ravel()))
        b_norm = float(jnp.linalg.norm(b.ravel()))
        assert true_res < 1e-7 * b_norm

    @pytest.mark.slow
    def test_bf16_cycle_converges(self):
        # reduced-precision V-cycle (MGConfig.dtype="bfloat16"): the
        # preconditioner runs its smoothers/transfers in bf16 (half the memory
        # bytes) but must stay a fixed linear operator that still
        # preconditions CG to tight tolerances in a few extra iterations
        grid = Grid3D((32, 32, 32))
        A = make_laplacian_operator(grid)
        key = jax.random.PRNGKey(11)
        u = A.project(grid.random(key).astype(jnp.float32))
        b = A(u)
        M16 = make_mg_preconditioner(grid.n, grid.deltas,
                                     MGConfig(dtype="bfloat16"),
                                     dtype=jnp.float32)
        out = M16(b)
        assert out.dtype == b.dtype  # casts back to the field dtype
        res = cg(A, b, M=M16, rtol=1e-6, max_it=50)
        ref = cg(A, b, M=make_mg_preconditioner(
            grid.n, grid.deltas, MGConfig(), dtype=jnp.float32),
            rtol=1e-6, max_it=50)
        assert bool(res.converged)
        # bf16 smoothing may cost a few extra outer iterations, no more
        assert int(res.iterations) <= int(ref.iterations) + 4

    @pytest.mark.slow
    def test_iteration_count_mesh_independence(self):
        # multigrid's defining property: iterations ~ constant in n
        counts = []
        for n in (8, 16, 32):
            grid = Grid3D((n, n, n))
            A = make_laplacian_operator(grid)
            M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig())
            key = jax.random.PRNGKey(10)
            u = A.project(grid.random(key))
            res = cg(A, A(u), M=M, rtol=1e-8, max_it=50)
            assert bool(res.converged)
            counts.append(int(res.iterations))
        assert max(counts) <= min(counts) + 3



class TestAutoSweeps:
    """pre/post_smooth=-1 (the default) resolves against the fine-grid
    size: 3+3 below 256^3-class, 2+2 at 256^3-class, 1+1 at 512^3-class;
    explicit values pass through untouched."""

    def test_resolution(self):
        from poissbox_tpu.solvers.mg import MGConfig, _resolve_sweeps
        small = _resolve_sweeps(MGConfig(), (64, 64, 64))
        assert (small.pre_smooth, small.post_smooth) == (3, 3)
        mid = _resolve_sweeps(MGConfig(), (256, 256, 256))
        assert (mid.pre_smooth, mid.post_smooth) == (2, 2)
        large = _resolve_sweeps(MGConfig(), (512, 512, 512))
        assert (large.pre_smooth, large.post_smooth) == (1, 1)
        explicit = _resolve_sweeps(MGConfig(pre_smooth=1, post_smooth=4),
                                   (512, 512, 512))
        assert (explicit.pre_smooth, explicit.post_smooth) == (1, 4)
        mixed = _resolve_sweeps(MGConfig(pre_smooth=1), (64, 64, 64))
        assert (mixed.pre_smooth, mixed.post_smooth) == (1, 3)

    def test_direct_v_cycle_rejects_sentinel(self):
        from poissbox_tpu.solvers.mg import MGConfig, v_cycle, _build_levels
        grid = Grid3D((8, 8, 8))
        cfg = MGConfig()
        levels = _build_levels(grid.n, grid.deltas, cfg)
        with pytest.raises(ValueError, match="auto"):
            v_cycle(levels, jnp.zeros((64, 64)), cfg,
                    jnp.zeros(grid.n, jnp.float64))


def _fft_pinv_numpy(b, deltas):
    """float64 numpy pseudo-inverse of the periodic 7-point operator."""
    b = np.asarray(b, np.float64)
    lam = sum(
        (-4.0 / d**2 * np.sin(np.pi * np.arange(m) / m) ** 2).reshape(
            [m if i == ax else 1 for i in range(3)])
        for ax, (m, d) in enumerate(zip(b.shape, deltas)))
    inv = np.where(lam == 0.0, 0.0, 1.0 / np.where(lam == 0.0, 1.0, lam))
    return np.real(np.fft.ifftn(np.fft.fftn(b) * inv))


class TestXlaVCycle:
    """Every smoother and cycle of the XLA V-cycle: a symmetric operator
    (CG requires it), and MG-CG converging to the float64 FFT solution."""

    @pytest.mark.parametrize("cycle", ["v", "w"])
    @pytest.mark.parametrize("smoother", ["sor", "jacobi", "chebyshev"])
    def test_symmetric(self, smoother, cycle):
        grid = Grid3D((16, 16, 16))
        M = jax.jit(make_mg_preconditioner(
            grid.n, grid.deltas, MGConfig(smoother=smoother, cycle=cycle,
                                          pre_smooth=2, post_smooth=2)))
        k1, k2 = jax.random.split(jax.random.PRNGKey(11))
        r1 = jax.random.normal(k1, grid.n, jnp.float64)
        r2 = jax.random.normal(k2, grid.n, jnp.float64)
        lhs = float(jnp.sum(M(r1) * r2))
        rhs = float(jnp.sum(r1 * M(r2)))
        assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs))

    @pytest.mark.parametrize("cycle", ["v", "w"])
    @pytest.mark.parametrize("smoother", ["sor", "jacobi", "chebyshev"])
    def test_converges_to_fft_reference(self, smoother, cycle):
        grid = Grid3D((16, 16, 16), (1.0, 1.0, 2.0))
        A = make_laplacian_operator(grid)
        M = make_mg_preconditioner(
            grid.n, grid.deltas, MGConfig(smoother=smoother, cycle=cycle))
        b = A.project(jax.random.normal(jax.random.PRNGKey(12), grid.n,
                                        jnp.float64))
        res = jax.jit(lambda r: cg(A, r, M=M, rtol=1e-10, max_it=60))(b)
        assert bool(res.converged), int(res.reason)
        want = _fft_pinv_numpy(b, grid.deltas)
        err = np.linalg.norm(np.asarray(res.x) - want)
        assert err <= 1e-7 * np.linalg.norm(want)

