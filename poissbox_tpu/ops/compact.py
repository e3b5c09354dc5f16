"""6th-order staggered compact finite-difference operators.

A re-design of the reference's compact-scheme stack (reference
src/compact_schemes.f90). Semantics preserved exactly — periodic, staggered
cell<->vertex operators where a derivative/interpolation couples each grid
line through a constant-coefficient periodic tridiagonal system:

    alpha*g_{i-1} + g_i + alpha*g_{i+1} = RHS_i(f)

The reference evaluates the n^2 pencils of each sweep with serial 1-D calls
(reference src/compact_schemes.f90:60-66, 70-76, 80-85); here each 1-D
operator acts along `axis` of the full 3-D array with the other axes as the
vectorized batch. The line solve is one of:

  * 'pcr' (default): scan-free circulant cyclic reduction
    (:mod:`poissbox_tpu.ops.compact_pcr`) — a few rolls and FMAs per
    step, fused by XLA, no axis moves;
  * 'pscan' / 'seq': the batched Thomas solvers of
    :mod:`poissbox_tpu.ops.tridiag` (log-depth associative scan, or a
    sequential scan), kept as the reference the PCR path is tested
    against. Their factorization of the fixed (alpha, 1, alpha) periodic
    Toeplitz system is computed once per (n, scheme, dtype) and folded
    into the compiled program as constants.

Sweep orders follow the reference: `grad` runs Z->Y->X
(cell->face->edge->vertex, src/compact_schemes.f90:42-88), `div` runs
X->Y->Z (vertex->edge->face->cell, src/compact_schemes.f90:207-257).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from poissbox_tpu.ops import compact_pcr
from poissbox_tpu.ops.coefficients import (
    CompactCoeffs,
    compact_grad_coeffs,
    compact_interp_coeffs,
)
from poissbox_tpu.ops.tridiag import TridiagFactor

Array = jax.Array

# Line-solve method behind method="auto" (PERF.md, "Bring-up findings",
# times compact.lapl with each at 512^3).
DEFAULT_METHOD = "pcr"
METHODS = ("pcr", "pscan", "seq")


# ---------------------------------------------------------------------------
# RHS evaluation (reference eval_1d_rhs, src/compact_schemes.f90:332-372)
# ---------------------------------------------------------------------------

def compact_rhs(f: Array, a: float, b: float, opsign: int, stagger: int,
                axis: int = -1) -> Array:
    """Periodic staggered compact-scheme RHS along `axis`.

    With shift = 0 (stagger=-1, cells->vertices) or 1 (stagger=+1,
    vertices->cells) and s = opsign (-1 difference, +1 interpolation):

        rhs_i = a*(f_{i+shift} + s*f_{i-1+shift}) + b*(f_{i+1+shift} + s*f_{i-2+shift})

    all indices periodic. `jnp.roll` by -k brings f_{i+k} to slot i; under
    GSPMD the rolls on a sharded axis become collective-permutes.
    """
    if stagger not in (-1, +1):
        raise ValueError(f"stagger must be -1 (cell->vertex) or +1 (vertex->cell), got {stagger}")
    if opsign not in (-1, +1):
        raise ValueError(f"opsign must be -1 (difference) or +1 (interpolation), got {opsign}")
    shift = 0 if stagger == -1 else 1
    s = float(opsign)

    def at(k: int) -> Array:  # f_{i+k}
        return jnp.roll(f, -k, axis=axis)

    return a * (at(shift) + s * at(shift - 1)) + b * (at(shift + 1) + s * at(shift - 2))


# ---------------------------------------------------------------------------
# cached periodic-Toeplitz factorizations
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _toeplitz_factor(n: int, alpha: float, dtype_name: str, method: str):
    """Factor the periodic (alpha, 1, alpha) system of size n, once.

    Runs eagerly and concretely no matter where the first call happens:
    trace contexts are thread-local, so building on a fresh thread escapes
    ANY ambient trace — `ensure_compile_time_eval` alone cannot escape an
    eager `shard_map` body trace (its constants stay ShardMapTracers, which
    would poison the cache). Under `jit` the factorization is baked into
    the executable as constants rather than recomputed per apply.
    """
    def build():
        dt = jnp.dtype(dtype_name)
        a = jnp.full((n,), alpha, dt)
        b = jnp.ones((n,), dt)
        c = jnp.full((n,), alpha, dt)
        return TridiagFactor(a, b, c, periodic=True, method=method)

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as ex:
        fac = ex.submit(build).result()
    # strip device arrays to host numpy: a cached factor must not leak one
    # trace context's aval mesh into later traces on a different mesh
    import numpy as _np
    for k, v in list(vars(fac).items()):
        if isinstance(v, jax.Array):
            setattr(fac, k, _np.asarray(v))
    return fac


def _apply_compact(f: Array, coeffs: CompactCoeffs, stagger: int, axis: int,
                   method: str = "auto") -> Array:
    n = f.shape[axis]
    if method == "auto":
        method = DEFAULT_METHOD
    if method == "pcr":
        spec = compact_pcr._spec(coeffs, coeffs.opsign, stagger, n,
                                 compact_pcr._dtype_rtol(f.dtype))
        return compact_pcr.pcr_op(f, spec, axis)
    if method not in METHODS:
        raise ValueError(f"unknown compact line-solve method {method!r} "
                         f"(expected auto|{'|'.join(METHODS)})")
    rhs = compact_rhs(f, coeffs.a, coeffs.b, coeffs.opsign, stagger, axis)
    fac = _toeplitz_factor(n, float(coeffs.alpha), jnp.dtype(f.dtype).name, method)
    return fac.solve(rhs, axis=axis)


# ---------------------------------------------------------------------------
# 1-D operators (batched along all other axes)
# ---------------------------------------------------------------------------

def grad_1d(f: Array, dx: float, stagger: int = -1, axis: int = -1,
            method: str = "auto") -> Array:
    """6th-order staggered first derivative along `axis`
    (reference src/compact_schemes.f90:155-204). Default stagger -1:
    cell-centered input, vertex-located derivative."""
    return _apply_compact(f, compact_grad_coeffs(dx), stagger, axis, method)


def div_1d(f: Array, dx: float, axis: int = -1, method: str = "auto") -> Array:
    """grad_1d with forward stagger (vertices->cells),
    reference src/compact_schemes.f90:260-268."""
    return grad_1d(f, dx, stagger=+1, axis=axis, method=method)


def interp_1d(f: Array, stagger: int = -1, axis: int = -1,
              method: str = "auto") -> Array:
    """6th-order staggered midpoint interpolation along `axis`
    (reference src/compact_schemes.f90:271-319)."""
    return _apply_compact(f, compact_interp_coeffs(), stagger, axis, method)


def interp_1d_div(f: Array, axis: int = -1, method: str = "auto") -> Array:
    """interp_1d with forward stagger (vertices->cells),
    reference src/compact_schemes.f90:322-329."""
    return interp_1d(f, stagger=+1, axis=axis, method=method)


# ---------------------------------------------------------------------------
# 3-D operators
# ---------------------------------------------------------------------------

def grad(f: Array, deltas: Sequence[float], method: str = "auto") -> Array:
    """Staggered gradient tensor of a cell-centered field: (nx, ny, nz, 3).

    Z->Y->X sweeps (cell->face->edge->vertex), interpolating the
    non-differenced components each sweep (reference
    src/compact_schemes.f90:42-88).
    """
    dx, dy, dz = deltas
    # Z sweep: components 1 and 2 get interpolated (shared), 3 differenced.
    fz_i = interp_1d(f, axis=2, method=method)
    fz_d = grad_1d(f, dz, axis=2, method=method)
    # Y sweep.
    c1 = interp_1d(fz_i, axis=1, method=method)
    c2 = grad_1d(fz_i, dy, axis=1, method=method)
    c3 = interp_1d(fz_d, axis=1, method=method)
    # X sweep.
    g1 = grad_1d(c1, dx, axis=0, method=method)
    g2 = interp_1d(c2, axis=0, method=method)
    g3 = interp_1d(c3, axis=0, method=method)
    return jnp.stack([g1, g2, g3], axis=-1)


def div(F: Array, deltas: Sequence[float], method: str = "auto") -> Array:
    """Divergence of a vertex-located vector field (nx, ny, nz, 3) -> cells.

    X->Y->Z sweeps (vertex->edge->face->cell), differencing one component per
    sweep and interpolating the rest (reference src/compact_schemes.f90:207-257).
    """
    dx, dy, dz = deltas
    # X sweep (vertex->edge).
    e1 = div_1d(F[..., 0], dx, axis=0, method=method)
    e2 = interp_1d_div(F[..., 1], axis=0, method=method)
    e3 = interp_1d_div(F[..., 2], axis=0, method=method)
    # Y sweep (edge->face).
    f1 = interp_1d_div(e1, axis=1, method=method)
    f2 = div_1d(e2, dy, axis=1, method=method)
    f3 = interp_1d_div(e3, axis=1, method=method)
    # Z sweep (face->cell): components 1+2 interpolated together, 3 differenced.
    return interp_1d_div(f1 + f2, axis=2, method=method) \
        + div_1d(f3, dz, axis=2, method=method)


def interp(f: Array, stagger: int = -1, method: str = "auto") -> Array:
    """Tri-directional interpolation, Z->Y->X (reference
    src/compact_schemes.f90:93-142)."""
    out = interp_1d(f, stagger=stagger, axis=2, method=method)
    out = interp_1d(out, stagger=stagger, axis=1, method=method)
    return interp_1d(out, stagger=stagger, axis=0, method=method)


def interp_div(f: Array, method: str = "auto") -> Array:
    """interp with forward (vertex->cell) staggering (reference
    src/compact_schemes.f90:144-152)."""
    return interp(f, stagger=+1, method=method)


def lapl(f: Array, deltas: Sequence[float], method: str = "auto") -> Array:
    """6th-order compact Laplacian: div(grad(f)) via staggered
    cell->vertex->cell evaluation (reference src/compact_schemes.f90:17-37).
    """
    return div(grad(f, deltas, method), deltas, method)


def make_compact_laplacian_operator(grid):
    """The 6th-order compact Laplacian as a first-class LinearOperator —
    the unification the reference never does (its compact stack is serial
    and test-only, reference CHANGELOG.md:9-20): solvable by Krylov methods
    (use the 2nd-order GMG preconditioner — the operators are spectrally
    equivalent) or exactly by `ksp_type="fft"` via the operator's rational
    trigonometric symbol (solvers.fft.compact_inv_eigenvalues).

    NOTE the staggered interpolation annihilates Nyquist modes, so the
    operator's kernel is larger than span{1}; the direct solve returns the
    minimal-norm pseudo-inverse solution, and Krylov solves expect a RHS
    in range(A) (e.g. manufactured b = A u).
    """
    from poissbox_tpu.linops import LinearOperator, make_nullspace_projector

    deltas = tuple(float(d) for d in grid.deltas)

    meshed = grid.mesh is not None and grid.mesh.size > 1

    def direct_solve(b):
        if meshed:  # pencil-FFT transposes keep every transform local
            from poissbox_tpu.solvers.fft import compact_poisson_solve_fft_dist
            return compact_poisson_solve_fft_dist(b, grid)
        from poissbox_tpu.solvers.fft import compact_poisson_solve_fft
        return compact_poisson_solve_fft(b, deltas)

    if meshed:  # pencil-transposed sweeps keep every line solve local
        from poissbox_tpu.ops import compact_dist
        apply = lambda u: compact_dist.lapl(u, grid)
    else:
        apply = lambda u: lapl(u, deltas)

    return LinearOperator(
        apply=apply,
        nullspace=make_nullspace_projector(),
        symmetric=True,
        direct_solve=direct_solve,
    )
