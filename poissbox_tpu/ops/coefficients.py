"""Finite-difference coefficient sets.

A re-design of the reference's coefficients module
(reference src/coefficients.f90:22-48) plus the compact-scheme constants
embedded in reference src/compact_schemes.f90:188-193 and 303-308, hoisted
here so operators, tests and the multigrid hierarchy share one source of
truth. Unlike the reference — which recomputes the 3x3x3 star at every grid
point inside the hot loop (src/poissbox.f90:143) — these are computed once
at trace time and folded into compiled kernels as constants.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


def lapl_1d_coeffs(dx, dtype=None):
    """[1, -2, 1] / dx^2 — 2nd-order 1-D Laplacian (reference coefficients.f90:22-35)."""
    dtype = dtype or jnp.result_type(float)
    invdx2 = 1.0 / jnp.asarray(dx, dtype) ** 2
    return jnp.stack([invdx2, -2.0 * invdx2, invdx2])


def lapl_star_coeffs(dx, dy, dz, dtype=None):
    """7-point star as a 3x3x3 coefficient box (reference coefficients.f90:38-48).

    Zero box; the x/y/z lines through the center carry the 1-D coefficients,
    accumulating -2(1/dx^2 + 1/dy^2 + 1/dz^2) at the center. Index order is
    (i, j, k) = (x, y, z) offsets, center at [1, 1, 1].
    """
    dtype = dtype or jnp.result_type(float)
    box = jnp.zeros((3, 3, 3), dtype)
    box = box.at[:, 1, 1].add(lapl_1d_coeffs(dx, dtype))
    box = box.at[1, :, 1].add(lapl_1d_coeffs(dy, dtype))
    box = box.at[1, 1, :].add(lapl_1d_coeffs(dz, dtype))
    return box


class CompactCoeffs(NamedTuple):
    """Parameters of a staggered compact scheme:

        alpha*g_{i-1} + g_i + alpha*g_{i+1} = a*(f_r + s*f_l) + b*(f_rr + s*f_ll)

    with s = opsign (-1 difference, +1 interpolation); see the RHS evaluator
    in ops.compact (reference src/compact_schemes.f90:332-372).
    """

    a: float
    b: float
    alpha: float
    opsign: int


def compact_grad_coeffs(dx) -> CompactCoeffs:
    """6th-order staggered first derivative (reference compact_schemes.f90:188-193)."""
    return CompactCoeffs(
        a=(63.0 / 62.0) / dx,
        b=(17.0 / 62.0) / (3.0 * dx),
        alpha=9.0 / 62.0,
        opsign=-1,
    )


def compact_interp_coeffs() -> CompactCoeffs:
    """6th-order staggered midpoint interpolation (reference compact_schemes.f90:303-308)."""
    return CompactCoeffs(a=0.75, b=1.0 / 20.0, alpha=3.0 / 10.0, opsign=+1)
