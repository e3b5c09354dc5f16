"""6th-order compact-scheme operator tests — ports of the reference's
grad/div/lapl MMS suites with its tolerance tiers (reference
tests/grad/test_grad_1d.f90, tests/grad/test_grad_3d.f90,
tests/div/test_div_1d.f90, tests/div/test_div_3d.f90,
tests/lapl/test_lapl.f90):

  * 1-D operators on n=128: exact on constants, RMS <= 1e-11 on sin fields;
  * 3-D grad on 64^3: separable fields per direction (isolates
    sweep-direction bugs) then combined;
  * 3-D div and Laplacian: RMS <= 1e-9;

Fields match the reference exactly: domain L = 2 pi, f = sin(x) (unit
wavenumber; reference test_grad_3d.f90:13,106). Tolerances are converted to
TRUE RMS: the reference normalizes `sqrt(sum_ijk err^2 / nx) / (ny*nz)`
(test_grad_3d.f90:139-141), so its 1e-11 threshold equals a true RMS of
1e-11 * sqrt(ny*nz) = 6.4e-10 at 64^3; we assert the stricter-or-equal
true-RMS equivalents.
  * NaN guards on every RMS (the reference's `rms /= rms` check,
    test_grad_3d.f90:146), pre-polluted output conventions are moot here
    (pure functions), staggering conventions checked explicitly.

Staggering (reference tests/grad/test_grad_1d.f90:89-107): cell-centered
values live at x = (i + 1/2) dx, vertex values at x = i dx. `grad` maps
cells -> vertices, `div` maps vertices -> cells.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import rms

from poissbox_tpu.ops import compact

TWO_PI = 2.0 * np.pi
L = TWO_PI  # domain size (reference test_grad_3d.f90:13)


def _axes(n):
    dx = L / n
    cells = (np.arange(n) + 0.5) * dx
    verts = np.arange(n) * dx
    return dx, cells, verts


def _check(err):
    assert np.isfinite(err), "NaN guard tripped"
    return err


class TestGrad1D:
    def test_constant_field_zero(self):
        n = 128
        dx, _, _ = _axes(n)
        f = jnp.full((n,), 7.5)
        df = compact.grad_1d(f, dx)
        assert _check(rms(np.asarray(df))) < 1e-11

    def test_sin_to_cos(self):
        n = 128
        dx, cells, verts = _axes(n)
        f = jnp.sin(jnp.asarray(cells))
        df = compact.grad_1d(f, dx)
        expect = np.cos(verts)
        assert _check(rms(np.asarray(df) - expect)) < 1e-11

    def test_batched_matches_loop(self):
        # pencils are the batch dimension; a batched solve must equal
        # per-pencil solves
        n = 64
        dx, cells, _ = _axes(n)
        f = jnp.stack([jnp.sin(jnp.asarray(cells)),
                       jnp.cos(jnp.asarray(cells)),
                       jnp.sin(2 * jnp.asarray(cells))])
        batched = compact.grad_1d(f, dx, axis=-1)
        rows = jnp.stack([compact.grad_1d(f[i], dx) for i in range(3)])
        np.testing.assert_allclose(np.asarray(batched), np.asarray(rows),
                                   rtol=1e-13, atol=1e-13)


class TestInterp1D:
    def test_constant_preserved(self):
        n = 128
        f = jnp.full((n,), -2.25)
        fi = compact.interp_1d(f)
        np.testing.assert_allclose(np.asarray(fi), -2.25, rtol=1e-12)

    def test_sin_midpoints(self):
        n = 128
        dx, cells, verts = _axes(n)
        f = jnp.sin(jnp.asarray(cells))
        fi = compact.interp_1d(f)          # cells -> vertices
        expect = np.sin(verts)
        assert _check(rms(np.asarray(fi) - expect)) < 1e-11


class TestDiv1D:
    def test_vertex_to_cell_stagger(self):
        # input at vertices x = i dx, output at cells x = (i + 1/2) dx —
        # mirror of grad staggering (reference test_div_1d.f90:89-107)
        n = 128
        dx, cells, verts = _axes(n)
        f = jnp.sin(jnp.asarray(verts))
        df = compact.div_1d(f, dx)
        expect = np.cos(cells)
        assert _check(rms(np.asarray(df) - expect)) < 1e-11


class TestGrad3D:
    N = 64

    def _grid(self):
        n = self.N
        dx, cells, verts = _axes(n)
        C = jnp.asarray(cells)
        V = jnp.asarray(verts)
        return n, dx, C, V

    @pytest.mark.slow
    def test_constant_field(self):
        n, dx, _, _ = self._grid()
        g = compact.grad(jnp.full((n, n, n), 3.0), (dx, dx, dx))
        assert g.shape == (n, n, n, 3)
        assert _check(rms(np.asarray(g))) < 1e-11

    @pytest.mark.parametrize("direction", [0, 1, 2])
    def test_separable_single_direction(self, direction):
        # f varies along one axis only: isolates sweep-direction bugs
        # (reference test_grad_3d.f90 structure)
        n, dx, C, V = self._grid()
        shape = [1, 1, 1]
        shape[direction] = n
        f = jnp.broadcast_to(jnp.sin(C).reshape(shape), (n, n, n))
        g = np.asarray(compact.grad(f, (dx, dx, dx)))
        expect_d = np.cos(np.asarray(V))
        for comp in range(3):
            if comp == direction:
                got = np.moveaxis(g[..., comp], direction, -1)
                err = rms(got - expect_d)
            else:
                err = rms(g[..., comp])
            assert _check(err) < 6.4e-10, (direction, comp, err)

    def test_combined_field(self):
        n, dx, C, V = self._grid()
        f = (jnp.sin(C)[:, None, None]
             + jnp.sin(C)[None, :, None]
             + jnp.sin(C)[None, None, :])
        f = jnp.broadcast_to(f, (n, n, n))
        g = np.asarray(compact.grad(f, (dx, dx, dx)))
        cosv = np.cos(np.asarray(V))
        for comp in range(3):
            got = np.moveaxis(g[..., comp], comp, -1)
            err = rms(got - cosv[None, None, :])
            assert _check(err) < 6.4e-10, (comp, err)


class TestDiv3D:
    def test_sin_vector_field(self):
        # F = (sin x, sin y, sin z) at vertices -> div = sum of cos at cells
        # (reference test_div_3d.f90:57-144), RMS <= 1e-9
        n = 64
        dx, cells, verts = _axes(n)
        V = jnp.asarray(verts)
        Fx = jnp.broadcast_to(jnp.sin(V)[:, None, None], (n, n, n))
        Fy = jnp.broadcast_to(jnp.sin(V)[None, :, None], (n, n, n))
        Fz = jnp.broadcast_to(jnp.sin(V)[None, None, :], (n, n, n))
        F = jnp.stack([Fx, Fy, Fz], axis=-1)
        d = np.asarray(compact.div(F, (dx, dx, dx)))
        c = np.cos(np.asarray(cells))
        expect = c[:, None, None] + c[None, :, None] + c[None, None, :]
        assert _check(rms(d - expect)) < 1e-9


class TestInterp3D:
    def test_constant(self):
        f = jnp.full((16, 16, 16), 4.5)
        np.testing.assert_allclose(np.asarray(compact.interp(f)), 4.5,
                                   rtol=1e-12)

    def test_round_trip_consistency(self):
        # cells -> vertices -> cells must reproduce smooth fields to scheme
        # order
        n = 64
        dx, cells, _ = _axes(n)
        C = jnp.asarray(cells)
        f = jnp.broadcast_to(jnp.sin(C)[:, None, None], (n, n, n))
        back = compact.interp_div(compact.interp(f))
        assert _check(rms(np.asarray(back - f))) < 1e-9


class TestLaplCompact:
    @pytest.mark.slow
    def test_constant_zero(self):
        n = 32
        dx = 1.0 / n
        out = compact.lapl(jnp.full((n, n, n), 2.0), (dx, dx, dx))
        assert _check(rms(np.asarray(out))) < 1e-9

    def test_sum_of_sines(self):
        # f = sin x + sin y + sin z -> lapl f = -f at cell centers
        # (reference test_lapl.f90:57-132), RMS <= 1e-9
        n = 64
        dx, cells, _ = _axes(n)
        C = jnp.asarray(cells)
        f = (jnp.sin(C)[:, None, None]
             + jnp.sin(C)[None, :, None]
             + jnp.sin(C)[None, None, :])
        f = jnp.broadcast_to(f, (n, n, n))
        out = np.asarray(compact.lapl(f, (dx, dx, dx)))
        expect = -np.asarray(f)
        assert _check(rms(out - expect)) < 1e-9


