"""FFT direct-solver tests: the spectral inverse must be exact (to
floating point) for the discrete periodic 7-point operator, agree with the
Krylov solvers, and share their null-space semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.config import Options
from poissbox_tpu.mesh import Grid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator
from poissbox_tpu.solvers import cg, poisson_solve_fft, solve


def _problem(n=16, seed=0):
    grid = Grid3D((n, n, n))
    A = make_laplacian_operator(grid)
    u = A.project(jax.random.normal(jax.random.PRNGKey(seed), grid.n,
                                    jnp.float64))
    return grid, A, u, A(u)


def test_exact_inverse():
    grid, A, u, b = _problem(32)
    x = poisson_solve_fft(b, grid.deltas)
    assert float(jnp.max(jnp.abs(x - u))) < 1e-13
    rel = float(jnp.linalg.norm((A(x) - b).ravel())
                / jnp.linalg.norm(b.ravel()))
    assert rel < 1e-14


def test_matches_cg():
    grid, A, u, b = _problem(16, seed=1)
    x_fft = poisson_solve_fft(b, grid.deltas)
    x_cg = cg(A, b, rtol=1e-13, max_it=5000).x
    np.testing.assert_allclose(np.asarray(x_fft), np.asarray(x_cg),
                               rtol=1e-8, atol=1e-10)


def test_nullspace_annihilated():
    # constant RHS is pure null space -> zero solution (pseudo-inverse)
    grid = Grid3D((8, 8, 8))
    b = jnp.full(grid.n, 2.5, jnp.float64)
    x = poisson_solve_fft(b, grid.deltas)
    assert float(jnp.max(jnp.abs(x))) < 1e-13


def test_mean_free_output():
    grid, A, u, b = _problem(16, seed=2)
    x = poisson_solve_fft(b + 7.0, grid.deltas)  # shift b by a constant
    assert abs(float(jnp.mean(x))) < 1e-13
    np.testing.assert_allclose(np.asarray(x), np.asarray(u), atol=1e-12)


def test_anisotropic_and_noncubic():
    grid = Grid3D((16, 8, 32), length=(1.0, 0.5, 2.0))
    A = make_laplacian_operator(grid)
    u = A.project(jax.random.normal(jax.random.PRNGKey(3), grid.n,
                                    jnp.float64))
    b = A(u)
    x = poisson_solve_fft(b, grid.deltas)
    np.testing.assert_allclose(np.asarray(x), np.asarray(u), atol=1e-12)


def test_ksp_dispatch_fft():
    grid, A, u, b = _problem(16, seed=4)
    res = solve(A, b, Options(["-ksp_type", "fft"]), shape=grid.n,
                deltas=grid.deltas)
    assert bool(res.converged)
    assert int(res.iterations) == 1
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(u), atol=1e-12)


class TestCompactSpectral:
    """6th-order compact Laplacian as a solvable system — the unification
    of the reference's disjoint operator stacks (its compact schemes are
    serial and test-only, reference CHANGELOG.md:9-20)."""

    n = 32

    def test_symbol_matches_operator(self, rng):
        from poissbox_tpu.ops import compact
        from poissbox_tpu.solvers.fft import compact_inv_eigenvalues
        n = self.n
        d = (1.0 / n,) * 3
        f = jnp.asarray(rng.uniform(-1.0, 1.0, (n, n, n)))
        Af = compact.lapl(f, d, method="pscan")
        inv = compact_inv_eigenvalues((n, n, n), d, jnp.float64)
        S = jnp.where(inv != 0, 1.0 / jnp.where(inv != 0, inv, 1.0), 0.0)
        lhs = jnp.fft.fftn(Af)
        rhs = S * jnp.fft.fftn(f)
        err = jnp.max(jnp.abs(jnp.where(inv != 0, lhs - rhs, 0.0)))
        assert float(err) / float(jnp.max(jnp.abs(lhs))) < 1e-12

    def test_symbol_real_symmetric(self):
        # real symbol <=> symmetric operator (CG-admissible)
        from poissbox_tpu.solvers.fft import compact_inv_eigenvalues
        inv = compact_inv_eigenvalues((16, 16, 16), (1 / 16,) * 3,
                                      jnp.float64)
        assert float(jnp.max(jnp.abs(jnp.imag(inv)))) < 1e-14 * float(
            jnp.max(jnp.abs(inv)))

    def test_direct_solve_exact(self, rng):
        from poissbox_tpu.ops import compact
        from poissbox_tpu.solvers.fft import compact_poisson_solve_fft
        n = self.n
        d = (1.0 / n,) * 3
        u = jnp.asarray(rng.uniform(-1.0, 1.0, (n, n, n)))
        b = compact.lapl(u, d, method="pscan")
        x = compact_poisson_solve_fft(b, d)
        r = compact.lapl(x, d, method="pscan") - b
        assert (float(jnp.linalg.norm(r.ravel()))
                < 1e-12 * float(jnp.linalg.norm(b.ravel())))

    def test_mms_sixth_order_solution(self):
        # solve lapl x = -u for u = sin x + sin y + sin z on [0, 2*pi]:
        # the solution matches u at the scheme's 6th-order accuracy
        # (reference tier 1e-9 at 64^3, tests/lapl/test_lapl.f90)
        from poissbox_tpu.solvers.fft import compact_poisson_solve_fft
        n = 64
        dx = 2 * np.pi / n
        c = jnp.asarray((np.arange(n) + 0.5) * dx)
        u = (jnp.sin(c)[:, None, None] + jnp.sin(c)[None, :, None]
             + jnp.sin(c)[None, None, :])
        u = jnp.broadcast_to(u, (n, n, n)).astype(jnp.float64)
        x = compact_poisson_solve_fft(-u, (dx,) * 3)
        err = np.asarray(x - u)
        assert float(np.sqrt(np.mean(err**2))) < 1e-9

    @pytest.mark.slow
    def test_cg_with_gmg_preconditioner(self):
        # Krylov solve of the 6th-order system, preconditioned by the
        # 2nd-order geometric multigrid. The operators are spectrally
        # equivalent over resolved modes only (the staggered interp
        # annihilates Nyquist modes, so equivalence degrades there) — the
        # Krylov path is for smooth/resolved RHS; rough RHS should use the
        # exact spectral direct solve.
        from poissbox_tpu.ops.compact import make_compact_laplacian_operator
        from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner
        n = self.n
        g = Grid3D((n, n, n))
        x0, y0, z0 = g.coords()
        k = 2 * jnp.pi
        u = (jnp.sin(k * x0) * jnp.cos(2 * k * y0)
             + jnp.sin(3 * k * z0) + jnp.cos(k * (x0 + z0)))
        A = make_compact_laplacian_operator(g)
        u = A.project(u.astype(jnp.float64))
        b = A(u)
        M = make_mg_preconditioner(g.n, g.deltas, MGConfig(),
                                   dtype=jnp.float64)
        res = cg(A, b, M=M, rtol=1e-8, max_it=80)
        assert bool(res.converged), int(res.iterations)
        assert int(res.iterations) <= 60  # measured: 36 at 32^3
        r = A(res.x) - b
        assert (float(jnp.linalg.norm(r.ravel()))
                < 1e-6 * float(jnp.linalg.norm(b.ravel())))

    def test_poisson_solver_order6_api(self, rng):
        from poissbox_tpu.api import PoissonSolver
        from poissbox_tpu.config import SolverOptions
        ps = PoissonSolver((16, 16, 16), order=6,
                           options=SolverOptions(ksp_type="fft"),
                           dtype=jnp.float64)
        u = ps.A.project(jnp.asarray(rng.uniform(-1.0, 1.0, (16,) * 3)))
        b = ps.A(u)
        res = ps.solve(b)
        assert bool(res.converged)
        r = ps.A(res.x) - b
        assert (float(jnp.linalg.norm(r.ravel()))
                < 1e-10 * float(jnp.linalg.norm(b.ravel())))


class TestDistributedFFT:
    """Pencil-decomposed spectral solves on the 8-device mesh: the
    distributed direct solver the reference's PETSc path has no analogue
    for (its distributed solves are Krylov-only,
    reference src/poissbox.f90:293-296)."""

    @pytest.mark.parametrize("pgrid", [(8, 1, 1), (4, 2, 1), (2, 2, 2)])
    def test_dist_matches_serial(self, pgrid):
        from poissbox_tpu.mesh import make_device_mesh
        from poissbox_tpu.solvers.fft import poisson_solve_fft_dist
        n = 16
        grid = Grid3D((n, n, n), mesh=make_device_mesh(pgrid))
        A = make_laplacian_operator(grid)
        u = A.project(jax.random.normal(jax.random.PRNGKey(3), grid.n,
                                        jnp.float64))
        b = A(grid.shard(u))
        x_dist = jax.jit(lambda v: poisson_solve_fft_dist(v, grid))(b)
        x_serial = poisson_solve_fft(jax.device_get(b), grid.deltas)
        np.testing.assert_allclose(np.asarray(x_dist), np.asarray(x_serial),
                                   rtol=0, atol=1e-12)

    @pytest.mark.slow
    def test_dist_compact_direct_solve(self):
        from poissbox_tpu.mesh import make_device_mesh
        from poissbox_tpu.ops.compact import make_compact_laplacian_operator
        from poissbox_tpu.solvers.fft import compact_poisson_solve_fft
        n = 16
        grid = Grid3D((n, n, n), mesh=make_device_mesh((4, 2, 1)))
        A = make_compact_laplacian_operator(grid)
        u = A.project(jax.random.normal(jax.random.PRNGKey(4), grid.n,
                                        jnp.float64))
        b = A(grid.shard(u))
        x_dist = jax.jit(A.direct_solve)(b)
        x_serial = compact_poisson_solve_fft(jax.device_get(b), grid.deltas)
        np.testing.assert_allclose(np.asarray(x_dist), np.asarray(x_serial),
                                   rtol=0, atol=1e-11)

    @pytest.mark.slow
    def test_options_driven_dist_solve(self):
        from poissbox_tpu.mesh import make_device_mesh
        n = 16
        grid = Grid3D((n, n, n), mesh=make_device_mesh((2, 2, 2)))
        A = make_laplacian_operator(grid)
        u = A.project(jax.random.normal(jax.random.PRNGKey(5), grid.n,
                                        jnp.float64))
        b = A(grid.shard(u))
        res = solve(A, b, Options(["-ksp_type", "fft"]), grid=grid)
        assert bool(res.converged)
        assert float(jnp.max(jnp.abs(res.x - u))) < 1e-12


class TestFFTPreconditioner:
    """`-pc_type fft`: exact periodic inverse as a preconditioner."""

    def test_one_iteration_on_own_operator(self):
        # preconditioning the 7-point operator by its own exact inverse:
        # CG must converge immediately
        grid, A, u, b = _problem(16, seed=6)
        res = solve(A, b, Options(["-ksp_type", "cg", "-pc_type", "fft",
                                   "-ksp_rtol", "1e-12"]), grid=grid)
        assert bool(res.converged)
        assert int(res.iterations) <= 2
        assert float(jnp.max(jnp.abs(res.x - u))) < 1e-11

    @pytest.mark.slow
    def test_compact_system_fft_preconditioned(self):
        # 6th-order compact system preconditioned by the 2nd-order exact
        # inverse (spectrally equivalent over resolved modes): a handful of
        # FCG iterations on a smooth RHS
        from poissbox_tpu.ops.compact import make_compact_laplacian_operator
        n = 32
        g = Grid3D((n, n, n))
        x0, y0, z0 = g.coords()
        k = 2 * jnp.pi
        u = (jnp.sin(k * x0) * jnp.cos(2 * k * y0)
             + jnp.sin(3 * k * z0) + jnp.cos(k * (x0 + z0)))
        A = make_compact_laplacian_operator(g)
        u = A.project(u.astype(jnp.float64))
        b = A(u)
        res = solve(A, b, Options(["-ksp_type", "fcg", "-pc_type", "fft",
                                   "-ksp_rtol", "1e-10"]), grid=g)
        assert bool(res.converged), int(res.iterations)
        assert int(res.iterations) <= 20
        r = A(res.x) - b
        assert (float(jnp.linalg.norm(r.ravel()))
                < 1e-8 * float(jnp.linalg.norm(b.ravel())))


def _rfftn_packed(u):
    """3-D real FFT from the packed-real last-axis transform that the
    packed pencil solve uses, plus complex transforms along y and x."""
    from poissbox_tpu.solvers.fft import _rfft_last
    return jnp.fft.fft(jnp.fft.fft(_rfft_last(u), axis=1), axis=0)


class TestPackedRealFFT:
    """The pack-two/unpack real FFT along the last axis (`_rfft_last` /
    `_irfft_last`), which the packed pencil solve runs on each z-pencil,
    checked against numpy's rfftn."""

    @pytest.mark.parametrize("shape", [(8, 6, 16), (16, 16, 16),
                                       (4, 32, 64)])
    def test_matches_rfftn(self, rng, shape):
        from poissbox_tpu.solvers.fft import _irfft_last
        u = jnp.asarray(rng.uniform(-1, 1, shape), jnp.float32)
        got = np.asarray(_rfftn_packed(u))
        want = np.fft.rfftn(np.asarray(u)).astype(np.complex64)
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got - want)) <= 1e-5 * scale
        w = jnp.fft.ifft(jnp.fft.ifft(jnp.asarray(want), axis=0), axis=1)
        back = np.asarray(_irfft_last(w, shape[-1]))
        assert np.max(np.abs(back - np.asarray(u))) <= 1e-5

    def test_solver_uses_half_spectrum_layout(self):
        # the eigenvalue table in rfft layout must match the packed
        # spectrum shape
        from poissbox_tpu.solvers.fft import _inv_eigenvalues
        u = jnp.ones((8, 8, 8), jnp.float32)
        inv = _inv_eigenvalues((8, 8, 8), (0.1, 0.1, 0.1), jnp.float32,
                               rfft=True)
        assert _rfftn_packed(u).shape == inv.shape


def _numpy_pinv7(b, deltas):
    """float64 numpy pseudo-inverse of the periodic 7-point operator
    (full complex spectrum)."""
    b = np.asarray(b, np.float64)
    lam = sum(
        (-4.0 / d**2 * np.sin(np.pi * np.arange(m) / m) ** 2).reshape(
            [m if i == ax else 1 for i in range(3)])
        for ax, (m, d) in enumerate(zip(b.shape, deltas)))
    inv = np.where(lam == 0.0, 0.0, 1.0 / np.where(lam == 0.0, 1.0, lam))
    return np.real(np.fft.ifftn(np.fft.fftn(b) * inv))


ROUTE_SHAPES = [(8, 8, 8), (8, 6, 7), (5, 9, 11), (16, 8, 4)]


class TestSingleRoute:
    """One FFT route on every backend: rfftn/irfftn with the half
    spectrum, odd last axes included."""

    @pytest.mark.parametrize("shape", ROUTE_SHAPES)
    def test_poisson_matches_numpy(self, rng, shape):
        from poissbox_tpu.solvers.fft import poisson_solve_fft
        deltas = (0.1, 0.2, 0.15)
        b = rng.standard_normal(shape)
        b -= b.mean()
        got = np.asarray(poisson_solve_fft(jnp.asarray(b), deltas))
        want = _numpy_pinv7(b, deltas)
        assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))

    @pytest.mark.parametrize("shape", ROUTE_SHAPES)
    def test_compact_half_spectrum_solve(self, rng, shape):
        """The compact solve's half-spectrum route inverts the compact
        operator itself: A6 x == b for b in range(A6)."""
        from poissbox_tpu.ops import compact
        from poissbox_tpu.solvers.fft import compact_poisson_solve_fft
        deltas = tuple(1.0 / m for m in shape)
        u = jnp.asarray(rng.standard_normal(shape))
        lapl = jax.jit(lambda v: compact.lapl(v, deltas))
        b = lapl(u)
        x = compact_poisson_solve_fft(b, deltas)
        r = np.asarray(lapl(x) - b)
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(np.asarray(b))

