"""Batched tridiagonal solvers (Thomas / parallel-scan / periodic).

The replacement for the reference's serial Thomas solver
(reference src/tridsol.f90:22-115) and its periodic Sherman–Morrison variant
(src/tridsol.f90:34-74). Argument convention matches the reference's *actual*
usage — `(a=sub-diagonal, b=diagonal, c=super-diagonal, d=rhs)` — as pinned
by its test fixture (reference tests/tridiag/test_tdma_utils.f90:55-65); the
reference's dummy-argument comments mislabel b/c and are not followed.

Design:

  * Everything is **batched**: coefficient arrays are (n,) (shared across the
    batch — the compact-scheme case) or broadcastable to the RHS; the RHS
    carries arbitrary batch dimensions with the line along `axis`. The
    reference loops n^2 pencils serially (src/compact_schemes.f90:60-66);
    here the pencil batch is the vectorized dimension.
  * Two execution strategies for the sequential recurrences:
      - ``method='seq'``: `lax.scan` along the line — n steps, each a wide
        vectorized op over the batch. Best when the batch is huge.
      - ``method='pscan'``: both Thomas sweeps are first-order linear
        recurrences y_i = A_i*y_{i-1} + B_i, evaluated in O(log n) depth with
        `lax.associative_scan` — the data-parallel cyclic-reduction analogue.
  * The factorization (`thomas_factor`) is RHS-independent and hoisted, so
    repeated solves (every compact-scheme application) only run the two
    RHS sweeps. The reference recomputes the elimination in every call.
  * Periodic systems use the Sherman–Morrison construction with the
    reference's conditioning choice gamma = -b[0] (src/tridsol.f90:51),
    solving the main and auxiliary systems against one shared factorization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array


# ---------------------------------------------------------------------------
# first-order linear recurrence y_i = A_i * y_{i-1} + B_i
# ---------------------------------------------------------------------------

def _linrec(A: Array, B: Array, method: str, axis: int = 0, reverse: bool = False) -> Array:
    """Solve y_i = A_i*y_{i-1} + B_i along `axis` (y_{-1} = 0).

    A and B must have equal shapes. `reverse=True` runs the recurrence from
    the far end (y_i = A_i*y_{i+1} + B_i).
    """
    if method == "pscan":
        def combine(l, r):
            a_l, b_l = l
            a_r, b_r = r
            return a_r * a_l, a_r * b_l + b_r

        _, y = lax.associative_scan(combine, (A, B), axis=axis, reverse=reverse)
        return y
    elif method == "seq":
        A_ = jnp.moveaxis(A, axis, 0)
        B_ = jnp.moveaxis(B, axis, 0)

        def step(y_prev, ab):
            a, b = ab
            y = a * y_prev + b
            return y, y

        y0 = jnp.zeros_like(B_[0])
        _, y = lax.scan(step, y0, (A_, B_), reverse=reverse)
        return jnp.moveaxis(y, 0, axis)
    raise ValueError(f"unknown method {method!r} (expected 'seq' or 'pscan')")


# ---------------------------------------------------------------------------
# factorization (RHS-independent part of the forward elimination)
# ---------------------------------------------------------------------------

def _factor_1d(a: Array, b: Array, c: Array):
    """LU-factor 1-D coefficient vectors (n,) -> (w, bmod), both (n,).

    bmod_0 = b_0;  w_i = a_i / bmod_{i-1};  bmod_i = b_i - w_i * c_{i-1}
    (the reference's fwd_sweep diagonal update, src/tridsol.f90:90-93).
    The bmod recurrence is a continued fraction — inherently sequential — so
    it runs as a scan; it is computed once per coefficient set and is
    RHS-independent, unlike the reference which re-eliminates every call.
    """

    def step(bprev, ac):
        ai, cprev, bi = ac
        w = ai / bprev
        bmod = bi - w * cprev
        return bmod, (w, bmod)

    _, (w_tail, bmod_tail) = lax.scan(step, b[0], (a[1:], c[:-1], b[1:]))
    w = jnp.concatenate([jnp.zeros_like(b[:1]), w_tail])
    bmod = jnp.concatenate([b[:1], bmod_tail])
    return w, bmod


# ---------------------------------------------------------------------------
# sweeps (exported for white-box tests, mirroring the reference's exports,
# reference src/tridsol.f90:17-18)
# ---------------------------------------------------------------------------

def fwd_sweep(a: Array, b: Array, c: Array, d: Array, axis: int = -1,
              method: str = "seq"):
    """Forward elimination. Returns (bmod, dmod) — the reference mutates
    b and d in place (src/tridsol.f90:90-94); we return the new values."""
    a1, b1, c1 = jnp.broadcast_arrays(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    if a1.ndim != 1:
        raise ValueError("fwd_sweep expects 1-D coefficient vectors")
    w, bmod = _factor_1d(a1, b1, c1)
    dmod = _apply_fwd(w, d, axis, method)
    return bmod, dmod


def bwd_sweep(b: Array, c: Array, d: Array, axis: int = -1, method: str = "seq"):
    """Back substitution: x_n = d_n/b_n; x_i = (d_i - c_i x_{i+1}) / b_i
    (reference src/tridsol.f90:110-113)."""
    b1, c1 = jnp.broadcast_arrays(jnp.asarray(b), jnp.asarray(c))
    return _apply_bwd(b1, c1, d, axis, method)


def _coef_shape(v: Array, d: Array, axis: int) -> Array:
    """Broadcast a (n,) coefficient vector against the RHS along `axis`."""
    axis = axis % d.ndim
    shape = [1] * d.ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def _apply_fwd(w: Array, d: Array, axis: int, method: str) -> Array:
    """dmod_i = d_i - w_i * dmod_{i-1} — first-order recurrence in dmod."""
    A = jnp.broadcast_to(-_coef_shape(w, d, axis), d.shape)
    return _linrec(A, d, method, axis=axis % d.ndim)


def _apply_bwd(bmod: Array, c: Array, d: Array, axis: int, method: str) -> Array:
    """x_i = d_i/bmod_i - (c_i/bmod_i) * x_{i+1} — reverse recurrence."""
    axis = axis % d.ndim
    bmod, c = jnp.asarray(bmod), jnp.asarray(c)
    binv = 1.0 / bmod
    B = d * _coef_shape(binv, d, axis)
    # x_i depends on x_{i+1} with coefficient -c_i/b_i, except the last row.
    cb = (c * binv).at[-1].set(0.0)
    A = jnp.broadcast_to(-_coef_shape(cb, d, axis), d.shape)
    return _linrec(A, B, method, axis=axis, reverse=True)


# ---------------------------------------------------------------------------
# public solvers
# ---------------------------------------------------------------------------

def tdma(a: Array, b: Array, c: Array, d: Array, axis: int = -1,
         method: str = "seq") -> Array:
    """Solve the (non-periodic) tridiagonal system along `axis` of d.

    a, b, c: (n,) sub-diagonal, diagonal, super-diagonal (a[0] and c[n-1]
    are ignored, as in the reference where corner entries are zeroed for
    non-periodic systems, reference tests/tridiag/test_tdma_utils.f90:39-42).
    d: RHS with the line along `axis` and arbitrary batch dims elsewhere.
    """
    a1, b1, c1 = jnp.broadcast_arrays(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    w, bmod = _factor_1d(a1, b1, c1)
    dmod = _apply_fwd(w, d, axis, method)
    return _apply_bwd(bmod, c1, dmod, axis, method)


class TridiagFactor:
    """Precomputed factorization of a fixed tridiagonal (or periodic
    tridiagonal) system, applied to many RHS batches.

    For the compact schemes the system matrix never changes (constant
    alpha/1/alpha periodic Toeplitz, reference src/compact_schemes.f90:191-193),
    so the elimination coefficients — and the periodic correction vector —
    are computed once at operator-construction time and closed over by the
    jitted apply.
    """

    def __init__(self, a, b, c, periodic: bool, method: str = "pscan"):
        a = jnp.asarray(a)
        b = jnp.asarray(b)
        c = jnp.asarray(c)
        a, b, c = jnp.broadcast_arrays(a, b, c)
        self.method = method
        self.periodic = periodic
        self.c = c
        if not periodic:
            self.w, self.bmod = _factor_1d(a, b, c)
            return
        # Sherman–Morrison setup (reference src/tridsol.f90:34-74):
        # gamma chosen as -b[0] to increase diagonal dominance.
        n = b.shape[0]
        gamma = -b[0]
        bmod = b.at[0].add(-gamma).at[n - 1].add(-(c[n - 1] * a[0] / gamma))
        self.w, self.bmod = _factor_1d(a, bmod, c)
        u = jnp.zeros_like(b).at[0].set(gamma).at[n - 1].set(c[n - 1])
        usol = self._solve_core(u, axis=0)
        self.alpha_ratio = a[0] / gamma
        self.usol = usol
        self.denom = 1.0 + usol[0] + self.alpha_ratio * usol[n - 1]

    def _solve_core(self, d: Array, axis: int) -> Array:
        dmod = _apply_fwd(self.w, d, axis, self.method)
        return _apply_bwd(self.bmod, self.c, dmod, axis, self.method)

    def solve(self, d: Array, axis: int = -1) -> Array:
        """Solve along `axis` of the (arbitrarily batched) RHS d."""
        axis = axis % d.ndim
        y = self._solve_core(d, axis)
        if not self.periodic:
            return y
        y0 = lax.index_in_dim(y, 0, axis, keepdims=True)
        yn = lax.index_in_dim(y, y.shape[axis] - 1, axis, keepdims=True)
        factor = (y0 + self.alpha_ratio * yn) / self.denom
        return y - _coef_shape(self.usol, d, axis) * factor


def tdma_periodic(a: Array, b: Array, c: Array, d: Array, axis: int = -1,
                  method: str = "seq") -> Array:
    """Solve the periodic tridiagonal system (corner entries a[0] coupling
    row 0 to row n-1 and c[n-1] coupling row n-1 to row 0) along `axis`.

    Sherman–Morrison with gamma = -b[0], two Thomas solves sharing one
    factorization — algorithm of reference src/tridsol.f90:34-74.
    """
    return TridiagFactor(a, b, c, periodic=True, method=method).solve(d, axis=axis)
