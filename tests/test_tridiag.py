"""Tridiagonal solver tests.

Ports of reference tests/tridiag/{test_tdma_sweeps,test_tdma,
test_tdma_periodic}.f90 plus the manufactured-solution fixture
(test_tdma_utils.f90), extended with the data-parallel concerns: both
execution methods (sequential scan and parallel associative scan) and
batched RHS along arbitrary axes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.ops.tridiag import (
    TridiagFactor,
    bwd_sweep,
    fwd_sweep,
    tdma,
    tdma_periodic,
)

from conftest import rms

METHODS = ["seq", "pscan"]


def make_system(rng, n, periodic=False):
    """Manufactured random diagonally-dominant system — reference
    tests/tridiag/test_tdma_utils.f90:12-67. Returns (a, b, c, x, d) with
    a=sub, b=diag, c=super, x=known solution, d=RHS."""
    a = rng.random(n)
    b = rng.random(n)
    c = rng.random(n)
    x = rng.random(n)
    if not periodic:
        a[0] = 0.0
        c[n - 1] = 0.0
    # force diagonal dominance by x10 escalation (test_tdma_utils.f90:45-52)
    while np.any(np.abs(b) < np.abs(a) + np.abs(c)):
        b = np.where(np.abs(b) < np.abs(a) + np.abs(c), 10 * b, b)
    d = b * x + c * np.roll(x, -1) + a * np.roll(x, 1)
    if not periodic:
        d[0] = b[0] * x[0] + c[0] * x[1]
        d[n - 1] = a[n - 1] * x[n - 2] + b[n - 1] * x[n - 1]
    return a, b, c, x, d


@pytest.mark.parametrize("method", METHODS)
def test_tdma_solves_random_system(rng, method):
    """TDMA solves a random diagonally-dominant system to ~eps
    (reference test_tdma.f90:18-38)."""
    n = 65
    a, b, c, x, d = make_system(rng, n)
    sol = np.asarray(tdma(a, b, c, jnp.asarray(d), method=method))
    assert rms(sol - x) < 1e5 * np.finfo(np.float64).eps * rms(x)


def test_tdma_fails_on_periodic_system(rng):
    """NEGATIVE test: a periodic system pushed through the non-periodic
    solver must NOT produce the true solution (reference test_tdma.f90:40-74)."""
    n = 65
    a, b, c, x, d = make_system(rng, n, periodic=True)
    sol = np.asarray(tdma(a, b, c, jnp.asarray(d)))
    assert rms(sol - x) > 1e-8 * rms(x)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("periodic", [True, False])
def test_tdma_periodic_solves_both(rng, method, periodic):
    """The periodic solver handles periodic AND non-periodic systems
    (reference test_tdma_periodic.f90:18-70)."""
    n = 64
    a, b, c, x, d = make_system(rng, n, periodic=periodic)
    sol = np.asarray(tdma_periodic(a, b, c, jnp.asarray(d), method=method))
    assert rms(sol - x) < 1e5 * np.finfo(np.float64).eps * rms(x)


def test_fwd_sweep_consistency(rng):
    """White-box: forward elimination leaves an upper bidiagonal system
    consistent with the original solution (reference
    test_tdma_sweeps.f90:37-75)."""
    n = 33
    a, b, c, x, d = make_system(rng, n)
    bmod, dmod = fwd_sweep(a, b, c, jnp.asarray(d))
    bmod, dmod = np.asarray(bmod), np.asarray(dmod)
    # residual of the eliminated system: bmod_i x_i + c_i x_{i+1} = dmod_i
    res = bmod * x + np.concatenate([c[:-1] * x[1:], [0.0]]) - dmod
    assert rms(res) < 1e4 * np.finfo(np.float64).eps * rms(dmod)


def test_bwd_sweep_solves_upper_bidiagonal(rng):
    """White-box: back substitution solves a constructed upper-bidiagonal
    system (reference test_tdma_sweeps.f90:77-117)."""
    n = 33
    b = 1.0 + rng.random(n)
    c = rng.random(n)
    c[-1] = 0.0
    x = rng.random(n)
    d = b * x + np.concatenate([c[:-1] * x[1:], [0.0]])
    sol = np.asarray(bwd_sweep(b, c, jnp.asarray(d)))
    assert rms(sol - x) < 1e4 * np.finfo(np.float64).eps * rms(x)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_batched_solve_any_axis(rng, method, axis):
    """Batched RHS: solving along any axis of a 3-D array matches looped
    1-D solves (the batched replacement for the reference's serial pencil
    loops, reference src/compact_schemes.f90:60-66)."""
    n, b1, b2 = 32, 5, 7
    a, b, c, x, d = make_system(rng, n, periodic=True)
    shape = [b1, b2]
    shape.insert(axis, n)
    rhs = rng.random(shape)
    fac = TridiagFactor(a, b, c, periodic=True, method=method)
    sol = np.asarray(fac.solve(jnp.asarray(rhs), axis=axis))
    # dense reference solve per pencil (vectorized)
    M = np.diag(b) + np.diag(c[:-1], 1) + np.diag(a[1:], -1)
    M[0, n - 1] = a[0]
    M[n - 1, 0] = c[n - 1]
    rhs_lines = np.moveaxis(rhs, axis, -1).reshape(-1, n)
    expected = np.linalg.solve(M, rhs_lines.T).T.reshape(b1, b2, n)
    expected = np.moveaxis(expected, -1, axis)
    assert rms(sol - expected) < 1e5 * np.finfo(np.float64).eps * max(rms(expected), 1)


def test_methods_agree(rng):
    """seq and pscan are the same algorithm to roundoff."""
    n = 128
    a, b, c, x, d = make_system(rng, n, periodic=True)
    s1 = np.asarray(tdma_periodic(a, b, c, jnp.asarray(d), method="seq"))
    s2 = np.asarray(tdma_periodic(a, b, c, jnp.asarray(d), method="pscan"))
    assert rms(s1 - s2) < 1e4 * np.finfo(np.float64).eps * rms(s1)


def test_factor_reuse_matches_fresh_solve(rng):
    """Precomputed factorization (the hoisted-elimination optimization)
    gives the same answer as the one-shot solver."""
    n = 48
    a, b, c, x, d = make_system(rng, n, periodic=True)
    fac = TridiagFactor(a, b, c, periodic=True, method="seq")
    s1 = np.asarray(fac.solve(jnp.asarray(d)))
    s2 = np.asarray(tdma_periodic(a, b, c, jnp.asarray(d), method="seq"))
    np.testing.assert_allclose(s1, s2, rtol=0, atol=0)
