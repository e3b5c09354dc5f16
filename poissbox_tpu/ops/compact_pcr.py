"""Compact-scheme line solves via parallel cyclic reduction (PCR) — the
scan-free formulation of the 6th-order staggered stack.

Every compact-scheme 1-D operator solves the same *constant-coefficient
periodic* (circulant) tridiagonal system

    alpha*g_{i-1} + g_i + alpha*g_{i+1} = RHS_i(f)      (indices mod n)

(reference src/compact_schemes.f90:188-197, 303-312). A Thomas solve is a
serial recurrence along the line. For a circulant system cyclic reduction
collapses to *scalar* per-step coefficients: one elimination step is

    d <- d - f_k * (roll(d, +s) + roll(d, -s)),   s = 2^k

with f_k = a_k/b_k, a_{k+1} = -a_k*f_k, b_{k+1} = b_k - 2*a_k*f_k — a pure
vector operation (no recurrence at all), and after log2(n)-1 steps the
system pairs (i, i+n/2):

    x_i = (b*d_i - 2*a*d_{i+n/2}) / (b^2 - 4*a^2).

All roll amounts are static, so an operator along any axis is a handful
of rolls and FMAs that XLA fuses into elementwise loops, with no axis
moves and no serial dependence along the line.

Exactness: for diagonally dominant circulant systems (both schemes:
alpha = 9/62, 3/10 < 1/2) PCR is a direct solve; numpy validation puts it
at machine epsilon against a dense solve for n = 8..256 (see
tests/test_compact_pcr.py). The exact ladder needs power-of-two n; the
truncated schedule (`rtol` > 0, what ops.compact uses) runs at any n >= 4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from poissbox_tpu.ops.coefficients import (
    compact_grad_coeffs,
    compact_interp_coeffs,
)

Array = jax.Array


# ---------------------------------------------------------------------------
# host-side schedule
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def pcr_schedule(alpha: float, n: int,
                 rtol: float = 0.0) -> tuple[tuple[float, ...], float, float]:
    """Scalar elimination factors (f_0, f_1, ...) and the final (b, a) of
    the circulant (alpha, 1, alpha) system of size n, computed once in f64
    on the host and baked into kernels as constants.

    One elimination step is pure circulant-operator algebra:
    (I - f(P^s + P^-s)) (bI + a(P^s + P^-s)) = b'I + a'(P^2s + P^-2s) with
    f = a/b, a' = -a f, b' = b - 2 a f — exact for ANY n and any stride
    (shifts wrap mod n; the identity never assumes the taps are distinct,
    and P^s = I degenerates consistently). Diagonal dominance compounds
    QUADRATICALLY (|a'| = a^2/|b|), so the factors decay like alpha^(2^k):
    with `rtol` > 0 the schedule truncates once |f_k| < rtol — the dropped
    correction perturbs the solution by O(rtol). For f32 that is ~4-5
    steps, INDEPENDENT of n — which frees the solve from the power-of-two
    restriction (640 = 5*2^7 runs the same schedule as 512).
    rtol = 0 keeps the exact direct solve via the final (i, i+n/2)
    pairing, which does require power-of-two n."""
    if rtol <= 0.0 and (n < 4 or n & (n - 1)):
        raise ValueError(
            f"exact (rtol=0) PCR needs power-of-two n >= 4, got {n}; "
            "pass a truncation rtol for arbitrary n")
    a, b = float(alpha), 1.0
    fs = []
    s = 1
    # rtol > 0: truncation terminates the loop (quadratic decay; 64 steps
    # is an unreachable backstop). rtol = 0: classic log2(n) - 1 ladder.
    limit = n // 2 if rtol <= 0.0 else n * 64
    while s < limit:
        f = a / b
        if rtol > 0.0 and abs(f) < rtol:
            a = 0.0
            break
        fs.append(f)
        a, b = -a * f, b - 2.0 * a * f
        s *= 2
    if rtol > 0.0 and abs(a / b) < rtol:
        a = 0.0
    return tuple(fs), b, a


def _dtype_rtol(dtype) -> float:
    """Truncation tolerance: a quarter ulp of the compute dtype."""
    return float(jnp.finfo(jnp.dtype(dtype)).eps) * 0.25


def _spec(coeffs, opsign: int, stagger: int, n: int, rtol: float = 0.0):
    """Static op descriptor: (a, b, opsign, shift, schedule)."""
    shift = 0 if stagger == -1 else 1
    return (float(coeffs.a), float(coeffs.b), int(opsign), shift,
            pcr_schedule(float(coeffs.alpha), n, rtol))


def grad_spec(d: float, stagger: int, n: int, rtol: float = 0.0):
    return _spec(compact_grad_coeffs(d), -1, stagger, n, rtol)


def interp_spec(stagger: int, n: int, rtol: float = 0.0):
    return _spec(compact_interp_coeffs(), +1, stagger, n, rtol)


# ---------------------------------------------------------------------------
# value-level building blocks
# ---------------------------------------------------------------------------

def _vroll(c, k: int, axis: int):
    """Periodic roll by static k (any sign): out[i] = c[i-k] along axis."""
    k %= c.shape[axis]
    return c if k == 0 else jnp.roll(c, k, axis)


def _vrhs(c, axis: int, a: float, b: float, opsign: int, shift: int):
    """Staggered compact RHS (reference src/compact_schemes.f90:332-372):
    rhs_i = a*(f_{i+sh} + s*f_{i+sh-1}) + b*(f_{i+sh+1} + s*f_{i+sh-2})."""
    s = float(opsign)

    def at(k: int):  # f_{i+k}
        return _vroll(c, -k, axis)

    return (a * (at(shift) + s * at(shift - 1))
            + b * (at(shift + 1) + s * at(shift - 2)))


def _vpcr(d, axis: int, sched):
    """Solve the circulant (alpha, 1, alpha) system along `axis`."""
    fs, bF, aF = sched
    n = d.shape[axis]
    s = 1
    for f in fs:
        d = d - f * (_vroll(d, s, axis) + _vroll(d, -s, axis))
        s *= 2
    if aF == 0.0:  # truncated schedule: off-diagonal below roundoff
        return d * (1.0 / bF)
    dn = _vroll(d, n // 2, axis)
    inv = 1.0 / (bF * bF - 4.0 * aF * aF)
    return (bF * inv) * d - (2.0 * aF * inv) * dn


def pcr_op(f: Array, spec, axis: int) -> Array:
    """One staggered compact operator along `axis`: the RHS taps, then the
    circulant solve (spec from :func:`_spec` / grad_spec / interp_spec)."""
    a, b, opsign, shift, sched = spec
    return _vpcr(_vrhs(f, axis, a, b, opsign, shift), axis, sched)
