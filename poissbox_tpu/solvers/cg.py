"""Preconditioned conjugate gradients — the `-ksp_type cg` path.

The reference's recommended solver is PETSc CG (reference README.md:42-47),
run through `KSPSolve` with a null-space-projected singular operator
(reference src/poissbox.f90:284-296). This is that capability as one pure
JAX function: `lax.while_loop` outer iteration, global dot products that
GSPMD lowers to psum over the device mesh, optional preconditioner closure,
and null-space projection of the right-hand side and of every preconditioned
residual (PETSc's MatNullSpace semantics).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from poissbox_tpu.linops import LinearOperator
from poissbox_tpu.solvers.result import SolveResult, classify

Array = jax.Array


def _monitor_print(k, rnorm) -> None:
    """Host callback for live `-ksp_monitor` streaming (PETSc line format)."""
    print(f"  {int(k)} KSP Residual norm {float(rnorm):.12e}", flush=True)


def emit_monitor(k: Array, rnorm: Array) -> None:
    """Stream one residual line from inside a jitted solver loop.

    PETSc's `-ksp_monitor` prints *while* KSPSolve runs (reference
    README.md:48-49); post-hoc `SolveResult.monitor_lines()` cannot give
    that for a 10-minute 1024^3-class solve. `jax.debug.callback` with
    ordered semantics keeps the lines in iteration order under jit and
    inside `lax.while_loop`; ordered effects are single-device-only in
    XLA, so multi-device solves stream unordered — each line carries its
    iteration index, and in practice the loop-carried dependence keeps
    them sequential anyway.
    """
    jax.debug.callback(_monitor_print, k, rnorm,
                       ordered=jax.device_count() == 1)


class _CGState(NamedTuple):
    x: Array
    r: Array
    p: Array         # search direction
    rz: Array        # <r, z> for the current residual
    resnorm: Array   # ||r||_2
    k: Array         # iteration counter
    hist: Array      # residual-norm history


def _dot(a: Array, b: Array) -> Array:
    """Global inner product; on sharded operands XLA inserts the psum."""
    return jnp.sum(a * b)


def cg(
    A: LinearOperator,
    b: Array,
    x0: Optional[Array] = None,
    *,
    M: Optional[Callable[[Array], Array]] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 500,
    norm_type: str = "unpreconditioned",
    flexible: bool = False,
    monitor: bool = False,
) -> SolveResult:
    """Solve A x = b by (preconditioned) CG.

    Args:
      A: symmetric linear operator (optionally singular with an attached
        null-space projector — the periodic Poisson case).
      b: right-hand side field.
      x0: initial guess (zero if omitted).
      M: preconditioner closure z = M(r) (identity if omitted).
      rtol/atol/max_it: stopping controls (reference README.md:48: default
        rtol 1e-5 via `-ksp_rtol`).
      norm_type: residual norm monitored for convergence, relative to ||b||.
        'unpreconditioned' (default) uses the true ||r||_2 — a deliberate
        deviation from PETSc KSPCG (whose default norm involves the
        preconditioner) chosen because the demo/tests verify the *true*
        residual; 'natural' uses sqrt(<r, M r>) (PETSc KSP_NORM_NATURAL),
        which costs no extra reduction since CG already forms <r, z>.
      monitor: stream a `-ksp_monitor` residual line per iteration from
        inside the jitted loop (live, not post-hoc — see :func:`emit_monitor`).
      flexible: use the Polak-Ribiere beta <r_{k+1}-r_k, z_{k+1}> / <r_k, z_k>
        instead of Fletcher-Reeves (PETSc KSPFCG with mmax=1, Notay's
        flexible CG). Mathematically identical for a fixed SPD
        preconditioner, but stays convergent when M varies between
        applications — a bf16 V-cycle whose rounding noise is
        iteration-dependent, level-rtol inner solves, or restarted inner
        Krylov smoothers. Costs one extra global reduction per iteration
        (<A p, z>; r_{k+1}-r_k = -alpha*A p so no extra vector is kept).

    Returns a :class:`SolveResult`; `history[i]` is the monitored norm at
    iteration i (NaN past the final iteration so the pytree has static
    shape under jit).
    """
    if norm_type not in ("unpreconditioned", "natural"):
        raise ValueError(f"unknown norm_type {norm_type!r} "
                         "(expected unpreconditioned|natural)")
    # Singular consistency: remove the null-space component from b and x
    # (PETSc removes it from the RHS when a MatNullSpace is attached).
    b = A.project(b)

    precond = M if M is not None else (lambda v: v)

    natural = norm_type == "natural"
    if x0 is None:
        # zero-guess specialization: r = b - A*0 = b, no matvec
        x = jnp.zeros_like(b)
        r = b
    else:
        x = A.project(x0)
        r = b - A(x)
    z = A.project(precond(r))
    p = z
    rz = _dot(r, z)
    # |<r, z>|: CG on a sign-consistent negative-definite pair (this
    # framework's Laplacian is negative definite, diag -2*sum(1/d^2)) is
    # identical to CG on the flipped positive pair, where the natural norm
    # is sqrt(-<r, z>); abs covers both orientations and keeps rounding
    # negatives near convergence from poisoning bnorm with sqrt(neg)=nan
    rnorm0 = (jnp.sqrt(jnp.abs(rz)) if natural
              else jnp.sqrt(_dot(r, r)))
    # Convergence is relative to ||b|| (KSPConvergedDefault-style; equals
    # the initial residual for a zero guess, correct for warm starts). In
    # the natural norm, evaluating sqrt(<b, M b>) would cost an extra
    # preconditioner application, so the initial natural residual stands in
    # (PETSc's KSPConvergedDefaultSetUIRNorm variant).
    bnorm = rnorm0 if natural else jnp.sqrt(_dot(b, b))

    hist = jnp.full((max_it + 1,), jnp.nan, dtype=b.dtype)
    hist = hist.at[0].set(rnorm0)
    if monitor:
        emit_monitor(jnp.int32(0), rnorm0)

    atol_ = jnp.asarray(atol, b.dtype)
    rtol_ = jnp.asarray(rtol, b.dtype)

    def cond(s: _CGState) -> Array:
        not_done = (s.resnorm > rtol_ * bnorm) & (s.resnorm > atol_)
        ok = jnp.isfinite(s.resnorm)
        return not_done & ok & (s.k < max_it)

    # The CANONICAL null-space projection (z = v - mean(v), marked by
    # linops.make_nullspace_projector) is rank-one, so it folds into the
    # reductions instead of costing its own memory passes:
    # <r, z> = <r, v> - mean(v) * sum(r) and the search-direction update
    # applies the mean shift inline. XLA then fuses the sibling reductions
    # (<r,v>, sum v, sum r) into one pass over (r, v) and the r-update
    # with the ||r||^2 reduction — the CG vector algebra runs in ~13 field
    # passes per iteration instead of 20. A CUSTOM projector (any other
    # callable) is applied explicitly instead — folding would silently
    # assume mean removal.
    project_z = A.nullspace is not None and getattr(
        A.nullspace, "is_constant_projector", False)
    explicit_proj = A.nullspace is not None and not project_z
    inv_n = 1.0 / b.size

    def body(s: _CGState) -> _CGState:
        p = s.p
        if A.apply_dot is not None:
            Ap, pAp = A.apply_dot(p)
        else:
            Ap = A(p)
            pAp = _dot(p, Ap)
        # breakdown guard: pAp (or rz) vanishes when the residual has
        # collapsed to rounding noise of the projected null space — stop
        # cleanly with the current iterate instead of dividing 0/0
        # (PETSc reports KSP_DIVERGED_BREAKDOWN; here the iterate is
        # already converged to working precision, so report that)
        ok = (pAp != 0.0) & (s.rz != 0.0)
        alpha = jnp.where(ok, s.rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = s.x + alpha * p
        r = s.r - alpha * Ap
        v = precond(r)
        if explicit_proj:
            v = A.project(v)
        if M is None and not explicit_proj:
            rr = _dot(r, r)
            rv, sv, sr = rr, jnp.sum(r), None
        else:
            rv = _dot(r, v)
            sv = jnp.sum(v)
            sr = jnp.sum(r)
            rr = None if natural else _dot(r, r)
        if project_z:
            rz_new = rv - sv * ((sv if sr is None else sr) * inv_n)
            zshift = sv * inv_n
        else:
            rz_new = rv
            zshift = 0.0
        if flexible:
            # beta_PR = <r_{k+1} - r_k, z_{k+1}> / rz_k = -alpha <A p, z> / rz_k
            # (z = v - zshift; <A p, 1> folds in like the other reductions)
            apz = _dot(Ap, v)
            if project_z:
                apz = apz - zshift * jnp.sum(Ap)
            numer = -alpha * apz
        else:
            numer = rz_new
        beta = jnp.where(ok, numer / jnp.where(ok, s.rz, 1.0), 0.0)
        norm = (jnp.sqrt(jnp.abs(rz_new)) if natural
                else jnp.sqrt(rr))
        resnorm = jnp.where(ok, norm, jnp.zeros_like(s.resnorm))
        k = s.k + 1
        hist = s.hist.at[k].set(resnorm)
        if monitor:
            emit_monitor(k, resnorm)
        p_next = (v - zshift) + beta * p
        return _CGState(x, r, p_next, rz_new, resnorm, k, hist)

    init = _CGState(x, r, p, rz, rnorm0, jnp.int32(0), hist)
    final = lax.while_loop(cond, body, init)

    reason = classify(final.resnorm, final.k, bnorm, rtol_, atol_, max_it)
    return SolveResult(
        x=A.project(final.x),
        iterations=final.k,
        residual_norm=final.resnorm,
        history=final.hist,
        reason=reason,
    )
