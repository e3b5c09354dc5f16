"""Edge-case tests: restart boundaries, non-divisible batches, degenerate
shapes — the places where static-shape kernels and masked loops go wrong.
"""

import jax
import jax.numpy as jnp
import numpy as np

from poissbox_tpu.mesh import Grid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator
from poissbox_tpu.ops.tridiag import TridiagFactor
from poissbox_tpu.solvers import cg, gmres


def _problem(n=8):
    grid = Grid3D((n, n, n))
    A = make_laplacian_operator(grid)
    key = jax.random.PRNGKey(7)
    u = A.project(jax.random.normal(key, grid.n, jnp.float64))
    return A, u, A(u)


class TestGMRESRestarts:
    def test_restart_smaller_than_iterations_needed(self):
        # forces several restart cycles
        A, u, b = _problem(8)
        res = gmres(A, b, rtol=1e-10, max_it=2000, restart=5)
        assert bool(res.converged)
        assert np.allclose(np.asarray(res.x), np.asarray(u), atol=1e-7)

    def test_restart_one(self):
        # GMRES(1) degenerates to a minimal-residual method; must still run
        A, u, b = _problem(4)
        res = gmres(A, b, rtol=1e-6, max_it=5000, restart=1)
        assert np.isfinite(float(res.residual_norm))

    def test_converges_mid_cycle(self):
        # convergence inside a restart cycle must not corrupt the solution
        # with the masked (inactive) Arnoldi steps
        A, u, b = _problem(8)
        res = gmres(A, b, rtol=1e-10, max_it=2000, restart=100)
        assert bool(res.converged)
        assert int(res.iterations) < 100  # converged within one cycle
        assert np.allclose(np.asarray(res.x), np.asarray(u), atol=1e-7)


class TestTridiagShapes:
    def _sys(self, n):
        a = jnp.full((n,), 0.2, jnp.float64)
        b = jnp.ones((n,), jnp.float64)
        c = jnp.full((n,), 0.2, jnp.float64)
        return a, b, c

    def test_small_n(self):
        # 4-point periodic line: the log-depth scan against the sequential
        a, b, c = self._sys(4)
        d = jax.random.normal(jax.random.PRNGKey(2), (4, 8, 128), jnp.float64)
        ref = TridiagFactor(a, b, c, periodic=True, method="seq").solve(d, axis=0)
        got = TridiagFactor(a, b, c, periodic=True, method="pscan").solve(d, axis=0)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)


class TestDegenerateSolves:
    def test_zero_rhs(self):
        A, _, _ = _problem(8)
        b = jnp.zeros((8, 8, 8), jnp.float64)
        res = cg(A, b, rtol=1e-8, max_it=10)
        assert float(jnp.max(jnp.abs(res.x))) == 0.0
        assert bool(res.converged)

    def test_constant_rhs_projected_out(self):
        # b = const is pure null-space content -> projected RHS is 0
        A, _, _ = _problem(8)
        b = jnp.full((8, 8, 8), 3.7, jnp.float64)
        res = cg(A, b, rtol=1e-8, max_it=10)
        assert float(jnp.max(jnp.abs(res.x))) < 1e-12

    def test_anisotropic_grid(self):
        # non-cubic cells: deltas differ per axis
        grid = Grid3D((16, 16, 16), length=(1.0, 2.0, 0.5))
        A = make_laplacian_operator(grid)
        key = jax.random.PRNGKey(3)
        u = A.project(jax.random.normal(key, grid.n, jnp.float64))
        res = cg(A, A(u), rtol=1e-10, max_it=5000)
        assert bool(res.converged)
        assert np.allclose(np.asarray(res.x), np.asarray(u), atol=1e-6)

    def test_non_cubic_shape(self):
        grid = Grid3D((16, 8, 32))
        A = make_laplacian_operator(grid)
        key = jax.random.PRNGKey(4)
        u = A.project(jax.random.normal(key, grid.n, jnp.float64))
        res = cg(A, A(u), rtol=1e-10, max_it=5000)
        assert bool(res.converged)
