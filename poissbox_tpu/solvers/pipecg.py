"""Pipelined conjugate gradients — the `-ksp_type pipecg` path.

Ghysels & Vanroose's single-reduction CG (Parallel Computing 40(7), 2014;
PETSc's KSPPIPECG). Standard CG needs two synchronizing global reductions
per iteration (<p, Ap> before the iterate update, <r, z> after it), and on
a multi-host mesh each reduction is a latency-bound collective the compute
cannot hide. PIPECG restructures the recurrences so that

  * the iteration's reduction group (<r, u>, <w, u>, ||r||^2) is
    *independent of* its operator applications (m = M w, n = A m), so XLA
    schedules the psum collectives concurrently with the matvec compute —
    the analogue of the MPI_Iallreduce overlap the algorithm
    was designed for; and
  * only ONE such reduction group remains per iteration.

The price is four extra recurrence vectors (z, q, s, p alongside x, r, u,
w) updated every iteration: ~2x the vector-algebra HBM traffic of plain
CG. On a single chip that trade is a pure loss — plain `cg` stays the
default; `pipecg` is for meshes where reduction latency dominates (the
reference's analogue would be running PETSc's `-ksp_type pipecg` instead
of its solver of record, plain CG, reference README.md:42-47, on a large
MPI communicator).

Like `cg`, the operator may be singular with an attached null-space
projector (reference src/poissbox.f90:284-291): b is projected once and
every preconditioned vector is projected (PETSc MatNullSpace semantics).

Numerical note: the residual is maintained by recurrence at one extra
remove compared to CG (r via s, s via w, w via z via n = A m), so its
rounding drift is larger; the true-residual floor sits a few orders above
machine epsilon but far below any practical rtol. Tests verify the true
residual against the recurrence norm at the reference tolerance tiers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from poissbox_tpu.linops import LinearOperator
from poissbox_tpu.solvers.result import SolveResult, classify

Array = jax.Array


class _State(NamedTuple):
    x: Array
    r: Array
    u: Array         # M r (projected)
    w: Array         # A u
    z: Array         # A q
    q: Array         # M s
    s: Array         # A p
    p: Array
    gamma: Array     # <r, u>  entering this iteration
    gamma_old: Array  # <r, u> of the previous iteration
    delta: Array     # <w, u>  entering this iteration
    alpha_old: Array  # previous step length
    resnorm: Array
    k: Array
    hist: Array


def _dot(a: Array, b: Array) -> Array:
    """Global inner product; on sharded operands XLA inserts the psum."""
    return jnp.sum(a * b)


def pipecg(
    A: LinearOperator,
    b: Array,
    x0: Optional[Array] = None,
    *,
    M: Optional[Callable[[Array], Array]] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 500,
    norm_type: str = "unpreconditioned",
    monitor: bool = False,
) -> SolveResult:
    """Solve A x = b by pipelined preconditioned CG (KSPPIPECG analogue).

    Same contract as :func:`poissbox_tpu.solvers.cg.cg` (projected RHS,
    `SolveResult` with history). `norm_type='unpreconditioned'` (default)
    monitors the recurrence ||r||_2 relative to ||b||; 'natural' monitors
    sqrt(<r, M r>) = sqrt(gamma), which PIPECG already computes — either way
    all three scalars live in the iteration's single fused reduction group,
    so the norm choice costs nothing extra.

    There is no `flexible` variant: PIPECG's scalar recurrence hard-codes
    the Fletcher-Reeves beta (the pipelining identity alpha_k depends on
    it), so a nonstationary preconditioner (e.g. a bf16 V-cycle) stalls it
    exactly like plain CG — use `fcg` there (PETSc likewise has no
    pipelined FCG with mmax-style truncation at one reduction).
    """
    if norm_type not in ("unpreconditioned", "natural"):
        raise ValueError(f"unknown norm_type {norm_type!r} "
                         "(expected unpreconditioned|natural)")
    natural = norm_type == "natural"
    b = A.project(b)
    precond = M if M is not None else (lambda v: v)

    def Mp(v: Array) -> Array:
        # project every preconditioned vector (MatNullSpace semantics);
        # for M = I the projection alone keeps the iterates mean-free
        return A.project(precond(v))

    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = A.project(x0)
        r = b - A(x)
    u = Mp(r)
    w = A(u)
    gamma = _dot(r, u)
    delta = _dot(w, u)
    # |gamma|: on a sign-consistent negative-definite (A, M) pair — this
    # framework's Laplacian — <r, u> is negative and the flipped system's
    # natural norm is sqrt(-gamma); abs covers both orientations
    rnorm0 = (jnp.sqrt(jnp.abs(gamma)) if natural
              else jnp.sqrt(_dot(r, r)))
    # natural norm: ||b||_M would cost an extra preconditioner apply, so the
    # initial natural residual stands in (as in cg's UIRNorm-style choice)
    bnorm = rnorm0 if natural else jnp.sqrt(_dot(b, b))

    zero = jnp.zeros_like(b)
    hist = jnp.full((max_it + 1,), jnp.nan, dtype=b.dtype)
    hist = hist.at[0].set(rnorm0)
    if monitor:
        from poissbox_tpu.solvers.cg import emit_monitor
        emit_monitor(jnp.int32(0), rnorm0)

    atol_ = jnp.asarray(atol, b.dtype)
    rtol_ = jnp.asarray(rtol, b.dtype)

    def cond(st: _State) -> Array:
        not_done = (st.resnorm > rtol_ * bnorm) & (st.resnorm > atol_)
        return not_done & jnp.isfinite(st.resnorm) & (st.k < max_it)

    def body(st: _State) -> _State:
        first = st.k == 0
        # m, n depend only on w — independent of gamma/delta, so the
        # reduction collectives overlap with this compute under XLA's
        # async scheduling
        m = Mp(st.w)
        n = A(m)
        # Scalar recurrence (Ghysels & Vanroose Alg. 4 / PETSc pipecg.c):
        #   k=0:  beta = 0,                    alpha = gamma / delta
        #   k>0:  beta = gamma_k / gamma_{k-1}
        #         alpha = gamma / (delta - beta * gamma / alpha_{k-1})
        beta = jnp.where(
            first | (st.gamma_old == 0.0), 0.0,
            st.gamma / jnp.where(st.gamma_old == 0.0, 1.0, st.gamma_old))
        # beta = 0 on the first iteration, so the correction term vanishes
        denom = st.delta - beta * st.gamma / jnp.where(
            st.alpha_old == 0.0, 1.0, st.alpha_old)
        # breakdown guard as in cg: freeze the iterate and stop cleanly
        # when the recurrence scalars collapse to rounding noise
        ok = (denom != 0.0) & (st.gamma != 0.0)
        alpha = jnp.where(ok, st.gamma / jnp.where(ok, denom, 1.0), 0.0)
        # vector recurrences; with beta = 0 and zero-initialized z/q/s/p
        # the first iteration reduces to z=n, q=m, s=w, p=u
        z = n + beta * st.z          # z = A q
        q = m + beta * st.q          # q = M s
        s = st.w + beta * st.s       # s = A p
        p = st.u + beta * st.p
        x = st.x + alpha * p
        r = st.r - alpha * s
        u = st.u - alpha * q
        w = st.w - alpha * z
        # this iteration's reduction group — consumed only NEXT iteration
        gamma = _dot(r, u)
        delta = _dot(w, u)
        norm = (jnp.sqrt(jnp.abs(gamma)) if natural
                else jnp.sqrt(_dot(r, r)))
        resnorm = jnp.where(ok, norm, jnp.zeros_like(st.resnorm))
        k = st.k + 1
        hist = st.hist.at[k].set(resnorm)
        if monitor:
            from poissbox_tpu.solvers.cg import emit_monitor
            emit_monitor(k, resnorm)
        return _State(x, r, u, w, z, q, s, p, gamma, st.gamma, delta,
                      alpha, resnorm, k, hist)

    init = _State(x, r, u, w, zero, zero, zero, zero, gamma,
                  jnp.zeros_like(gamma), delta, jnp.zeros_like(gamma),
                  rnorm0, jnp.int32(0), hist)
    final = lax.while_loop(cond, body, init)

    reason = classify(final.resnorm, final.k, bnorm, rtol_, atol_, max_it)
    return SolveResult(
        x=A.project(final.x),
        iterations=final.k,
        residual_norm=final.resnorm,
        history=final.hist,
        reason=reason,
    )
