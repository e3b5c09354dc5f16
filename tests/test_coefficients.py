"""Coefficient property tests.

Ports of the reference's exactness-on-polynomials tests:
  * 1-D Laplacian coefficients (reference tests/coefficients/test_d2dx2.f90)
  * 3-D 7-point star (reference tests/coefficients/test_star.f90)
  * compact-scheme discrete identities (reference tests/coefficients/test_compact.f90)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.ops.coefficients import (
    compact_grad_coeffs,
    compact_interp_coeffs,
    lapl_1d_coeffs,
    lapl_star_coeffs,
)

from conftest import feq

# fixture constants from reference test_d2dx2.f90:15-26
A, B, C = 2.718, 1.414, 1.848
X, DX = 1.618, 0.155
SHIFT = 17.29


def eval_lapl_1d(f, dx):
    """Grouped evaluation (f_+1 + f_-1) then center — the numerically
    preferred ordering (reference test_d2dx2.f90:185-190)."""
    c = np.asarray(lapl_1d_coeffs(dx))
    return (c[0] * f[0] + c[2] * f[2]) + c[1] * f[1]


def fields_1d(dx=DX):
    pts = np.array([X - dx, X, X + dx])
    fc = np.full(3, C)          # constant
    fg = B * pts                # constant gradient
    fq = A * pts**2             # quadratic
    return fc, fg, fq


@pytest.mark.parametrize("name,expected", [("fc", 0.0), ("fg", 0.0), ("fq", 2 * A)])
def test_lapl_1d_exactness(name, expected):
    fc, fg, fq = fields_1d()
    f = {"fc": fc, "fg": fg, "fq": fq}[name]
    # plain (scaled by dx^2 as the reference does for absolute comparisons)
    assert feq(eval_lapl_1d(f, DX) * DX**2, expected * DX**2)
    # proportionality under scaling (reference test_scaled_lapl)
    assert feq(eval_lapl_1d(2 * f, DX), 2 * expected)
    assert feq(eval_lapl_1d(f / 2, DX) * DX**2, expected * DX**2 / 2)
    # invariance under shift (reference test_shifted_lapl)
    assert feq(eval_lapl_1d(f + SHIFT, DX) * DX**2, expected * DX**2)
    assert feq(eval_lapl_1d(f - SHIFT, DX) * DX**2, expected * DX**2)


@pytest.mark.parametrize("name", ["fc", "fg"])
def test_lapl_1d_spacing(name):
    """Grid-spacing changes (reference test_spacing_lapl — constant and
    constant-gradient fields only, whose sample values are spacing-free)."""
    fc, fg, _ = fields_1d()
    f = {"fc": fc, "fg": fg}[name]
    for dx2 in (2 * DX, DX / 2):
        assert feq(eval_lapl_1d(f, dx2) * dx2**2, 0.0)


def separable_3d(fx):
    """f(i,j,k) = fx(i) + fx(j) + fx(k) — the reference's tri-directional
    field construction (reference test_star.f90:50-84)."""
    f = np.zeros((3, 3, 3))
    f += fx[:, None, None]
    f += fx[None, :, None]
    f += fx[None, None, :]
    return f


@pytest.mark.parametrize("name,expected", [("fc", 0.0), ("fg", 0.0), ("fq", 3 * 2 * A)])
def test_star_3d(name, expected):
    fc_x, fg_x, fq_x = fields_1d()
    fx = {"fc": fc_x, "fg": fg_x, "fq": fq_x}[name]
    f = separable_3d(fx)
    star = np.asarray(lapl_star_coeffs(DX, DX, DX))
    val = float(np.vdot(star, f))
    tol = 100 * 1.1 * np.finfo(np.float64).eps  # reference test_star.f90:163
    assert feq(val * DX**2, expected * DX**2, tol)


def test_star_structure():
    """The star is exactly 7 nonzeros with the right values."""
    dx, dy, dz = 0.1, 0.2, 0.4
    star = np.asarray(lapl_star_coeffs(dx, dy, dz))
    assert star.shape == (3, 3, 3)
    assert np.count_nonzero(star) == 7
    assert feq(star[0, 1, 1], 1 / dx**2)
    assert feq(star[1, 0, 1], 1 / dy**2)
    assert feq(star[1, 1, 0], 1 / dz**2)
    assert feq(star[1, 1, 1], -2 * (1 / dx**2 + 1 / dy**2 + 1 / dz**2))
    assert star[2, 1, 1] == star[0, 1, 1]
    assert star[1, 2, 1] == star[1, 0, 1]
    assert star[1, 1, 2] == star[1, 1, 0]


# ---------------------------------------------------------------------------
# compact-scheme discrete identities (reference test_compact.f90)
# ---------------------------------------------------------------------------

L, N = 6.28, 128
DXC = L / N
SCALES = [3.14, 0.817, -7.362, 8.981, -10.22, 0.071]


def _poly_fixture():
    """Cumulative polynomial fields f_p on 4 nodes, with derivative and
    interpolant samples around the center (reference test_compact.f90:50-112)."""
    xs = np.arange(4) * DXC
    xc = 1.5 * DXC
    f, df, fi = [], [], []
    acc_f = np.zeros(4)
    acc_df = np.zeros(3)
    acc_fi = np.zeros(3)
    for p, m in enumerate(SCALES):
        acc_f = acc_f + m * xs**p
        pts = np.array([xc - DXC, xc, xc + DXC])
        acc_df = acc_df + (p * m) * pts ** max(p - 1, 0) if p > 0 else acc_df + 0.0
        acc_fi = acc_fi + m * pts**p
        f.append(acc_f.copy())
        df.append(acc_df.copy())
        fi.append(acc_fi.copy())
    return f, df, fi


@pytest.mark.parametrize("p", range(6))
def test_compact_derivative_identity(p):
    """alpha*f'_{i-1/2} + f'_{i+1/2} + alpha*f'_{i+3/2} == a,b-weighted node
    values, exactly, for polynomials up to order 5 (6th-order scheme)."""
    f, df, _ = _poly_fixture()
    cd = compact_grad_coeffs(DXC)
    lhs_w = np.array([cd.alpha, 1.0, cd.alpha])
    rhs_w = np.array([-cd.b, -cd.a, cd.a, cd.b])
    delta = float(np.dot(rhs_w, f[p]) - np.dot(lhs_w, df[p]))
    assert abs(delta) <= 100 * np.finfo(np.float64).eps * max(1.0, abs(np.dot(lhs_w, df[p])))


@pytest.mark.parametrize("p", range(6))
def test_compact_interpolation_identity(p):
    f, _, fi = _poly_fixture()
    ci = compact_interp_coeffs()
    lhs_w = np.array([ci.alpha, 1.0, ci.alpha])
    rhs_w = np.array([ci.b, ci.a, ci.a, ci.b])
    delta = float(np.dot(rhs_w, f[p]) - np.dot(lhs_w, fi[p]))
    assert abs(delta) <= 100 * np.finfo(np.float64).eps * max(1.0, abs(np.dot(lhs_w, fi[p])))


def test_dtype_follows_input():
    """Kernels are dtype-polymorphic (f32 fast path)."""
    assert lapl_1d_coeffs(jnp.float32(0.5), jnp.float32).dtype == jnp.float32
    assert lapl_star_coeffs(0.1, 0.1, 0.1, jnp.float32).dtype == jnp.float32
