"""Mixed-precision iterative refinement — a fast path to f64 accuracy.

The reference runs everything in double precision because PETSc does
(reference src/constants.f90:9-17). f32 moves half the bytes of f64 per
field, and the solver is memory-bound. The answer here is iterative
refinement: solve corrections in fast f32 with the
MG-preconditioned Krylov solver, accumulate the solution and compute true
residuals in f64. Each outer iteration recovers ~7 digits, so 2-3 outer
iterations reach f64-level relative residuals (1e-12+) at f32 speed —
tighter than the reference's default rtol 1e-5 and its recommended 1e-8
runs (reference README.md:48).

    r_k = b - A x_k          (f64)
    solve A d = r_k to ~1e-6 (f32 MG-CG — the fast path)
    x_{k+1} = x_k + d        (f64)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from poissbox_tpu.linops import LinearOperator
from poissbox_tpu.solvers.result import SolveResult, classify

Array = jax.Array


class RefineResult(NamedTuple):
    x: Array                  # f64 solution
    outer_iterations: int
    inner_iterations: int     # total Krylov iterations across outer solves
    residual_norm: Array      # f64 true residual
    history: Array            # f64 residual after each outer iteration


def refine(
    A64: LinearOperator,
    inner_solve: Callable[[Array], SolveResult],
    b: Array,
    *,
    rtol: float = 1.0e-12,
    max_outer: int = 4,
    x0: Optional[Array] = None,
) -> RefineResult:
    """Iteratively refine to `rtol` in f64 using an f32 inner solver.

    Args:
      A64: the operator in f64 (residual evaluations).
      inner_solve: f32 correction solver, e.g. a jitted MG-CG closure; it
        receives the f32-cast residual and returns a SolveResult.
      b: f64 right-hand side.
      rtol: target relative true-residual.
      max_outer: outer iteration cap (each recovers ~7 digits).

    Host-driven outer loop (few iterations, each one device-bound inner
    solve); the inner solve is where all the time goes.

    Requires `jax_enable_x64`: without it `astype(float64)` silently yields
    f32 and the advertised 1e-12 residuals are unreachable.
    """
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "iterative refinement needs f64 residual accumulation: enable "
            "jax.config.update('jax_enable_x64', True) before calling "
            "refine() (without it the f64 casts silently stay f32 and "
            f"rtol={rtol:g} cannot be reached)")
    b = A64.project(b.astype(jnp.float64))
    x = jnp.zeros_like(b) if x0 is None else x0.astype(jnp.float64)
    bnorm = float(jnp.linalg.norm(b.ravel()))
    hist = []
    inner_total = 0
    resnorm = bnorm
    for k in range(max_outer):
        r = b - A64(x)
        resnorm = float(jnp.linalg.norm(r.ravel()))
        hist.append(resnorm)
        if resnorm <= rtol * bnorm:
            break
        inner = inner_solve(r.astype(jnp.float32))
        inner_total += int(inner.iterations)
        x = A64.project(x + inner.x.astype(jnp.float64))
    r = b - A64(x)
    resnorm = float(jnp.linalg.norm(r.ravel()))
    hist.append(resnorm)
    return RefineResult(
        x=x,
        outer_iterations=len(hist) - 1,
        inner_iterations=inner_total,
        residual_norm=jnp.asarray(resnorm),
        history=jnp.asarray(hist),
    )
