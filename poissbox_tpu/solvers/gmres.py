"""Restarted GMRES — PETSc's default KSP type.

The reference inherits GMRES as the default solver when no `-ksp_type` flag
is given (PETSc default; the reference recommends overriding with CG,
reference README.md:42-47). Provided here for capability parity: left-
preconditioned GMRES(m) with modified Gram–Schmidt and Givens rotations,
fully jit-compatible (`lax.while_loop` over restart cycles, `lax.fori_loop`
with convergence masking inside a cycle, static basis size).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from poissbox_tpu.linops import LinearOperator
from poissbox_tpu.solvers.result import SolveResult, classify

Array = jax.Array
_HIGHEST = lax.Precision.HIGHEST


class _CycleState(NamedTuple):
    V: Array        # (m+1, *field) Krylov basis
    H: Array        # (m+1, m) Hessenberg
    cs: Array       # (m,) Givens cosines
    sn: Array       # (m,) Givens sines
    g: Array        # (m+1,) rotated rhs
    resnorm: Array  # current (preconditioned) residual estimate
    jdone: Array    # number of Arnoldi steps actually taken
    hist: Array
    k: Array        # global iteration counter


class _OuterState(NamedTuple):
    x: Array
    resnorm: Array
    k: Array
    hist: Array


def _basis_budget_bytes() -> int:
    """HBM budget for the Krylov basis: a quarter of the device memory
    when discoverable, 4 GB otherwise. The (m+1, *field) basis is GMRES's
    dominant allocation; capping it at a fraction leaves room for the
    operator's own working set and XLA temporaries."""
    try:
        stats = jax.devices()[0].memory_stats()
        limit = int(stats.get("bytes_limit", 0))
        if limit > 0:
            return limit // 4
    except Exception:
        pass
    return 4 << 30


def clamp_restart(restart: int, b: Array, budget_bytes=None) -> int:
    """Auto-shrink the restart length so the stacked basis fits the budget.

    PETSc's GMRES(30) default (the reference's implicit default KSP,
    reference src/poissbox.f90:295) allocates 31 field-sized vectors — at
    512^3 f32 that is ~16.6 GB, more than a small device holds. Rather
    than OOM, shrink m to the largest affordable value and warn (more
    restarts, same convergence semantics)."""
    import warnings

    budget = _basis_budget_bytes() if budget_bytes is None else int(budget_bytes)
    field = int(b.size) * b.dtype.itemsize
    max_m = max(1, budget // max(field, 1) - 1)
    if restart > max_m:
        warnings.warn(
            f"gmres: restart {restart} needs {(restart + 1) * field / 2**30:.1f}"
            f" GiB of Krylov basis (> {budget / 2**30:.1f} GiB budget); "
            f"shrunk to restart={max_m}", RuntimeWarning, stacklevel=3)
        return max_m
    return restart


def gmres(
    A: LinearOperator,
    b: Array,
    x0: Optional[Array] = None,
    *,
    M: Optional[Callable[[Array], Array]] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 1000,
    restart: int = 30,
    monitor: bool = False,
) -> SolveResult:
    """Solve A x = b by left-preconditioned restarted GMRES(restart).

    Convergence is monitored on the preconditioned residual norm (PETSc's
    left-preconditioning default). History records one entry per inner
    iteration. `monitor=True` streams a `-ksp_monitor` line per inner
    iteration from inside the jitted Arnoldi loop (live — the Givens
    recurrence exposes the residual without forming the iterate).

    The restart length is auto-shrunk when the (restart+1)-vector Krylov
    basis would blow the HBM budget (see :func:`clamp_restart`).
    """
    m = clamp_restart(int(restart), b)
    x = jnp.zeros_like(b) if x0 is None else x0
    b = A.project(b)
    x = A.project(x)
    precond = M if M is not None else (lambda v: v)
    fdims = tuple(range(1, b.ndim + 1))  # field dims inside the stacked basis

    def pres(v: Array) -> Array:
        return A.project(precond(v))

    r0 = pres(b - A(x))
    rnorm0 = jnp.sqrt(jnp.sum(r0 * r0))
    pb = pres(b)
    bnorm = jnp.sqrt(jnp.sum(pb * pb))  # PETSc KSPConvergedDefault base
    hist = jnp.full((max_it + 1,), jnp.nan, dtype=b.dtype)
    hist = hist.at[0].set(rnorm0)
    if monitor:
        from poissbox_tpu.solvers.cg import emit_monitor
        emit_monitor(jnp.int32(0), rnorm0)

    atol_ = jnp.asarray(atol, b.dtype)
    rtol_ = jnp.asarray(rtol, b.dtype)
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)

    def target(_rn0):
        return jnp.maximum(rtol_ * bnorm, atol_)

    use_fused = M is None and A.apply_dot is not None

    def arnoldi_step(j: Array, s: _CycleState) -> _CycleState:
        active = (s.resnorm > target(rnorm0)) & (j == s.jdone)

        if use_fused:
            # unpreconditioned: the operator's matvec+dot returns
            # <V_j, A V_j> in the same pass — exactly the j-th MGS coefficient
            Av, vAv = A.apply_dot(s.V[j])
            w = A.project(Av)
        else:
            w = pres(A(s.V[j]))
        # Modified-Gram–Schmidt against the whole (zero-padded) basis: rows
        # beyond j are zero so they contribute nothing. HIGHEST precision:
        # an f32 contraction may otherwise run in TF32 (~3 digits), which
        # would quietly weaken the orthogonalisation.
        h = jnp.tensordot(s.V, w, axes=(fdims, tuple(range(b.ndim))),
                          precision=_HIGHEST)
        if use_fused:
            # the projection is rank-one (constant mean removal) and V_j is
            # mean-free, so <V_j, project(A V_j)> == <V_j, A V_j>
            h = h.at[j].set(vAv)
        w = w - jnp.tensordot(h, s.V, axes=((0,), (0,)), precision=_HIGHEST)
        hnext = jnp.sqrt(jnp.sum(w * w))
        vnext = w / jnp.maximum(hnext, tiny)

        hcol = h.at[j + 1].set(hnext)
        # apply accumulated Givens rotations to the new column
        def rot(i, col):
            hi = s.cs[i] * col[i] + s.sn[i] * col[i + 1]
            hip = -s.sn[i] * col[i] + s.cs[i] * col[i + 1]
            return lax.cond(i < j, lambda c: c.at[i].set(hi).at[i + 1].set(hip),
                            lambda c: c, col)
        hcol = lax.fori_loop(0, m, rot, hcol)

        denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        csj = hcol[j] / jnp.maximum(denom, tiny)
        snj = hcol[j + 1] / jnp.maximum(denom, tiny)
        hcol = hcol.at[j].set(csj * hcol[j] + snj * hcol[j + 1]).at[j + 1].set(0.0)
        gj = s.g[j]
        gnew = s.g.at[j].set(csj * gj).at[j + 1].set(-snj * gj)
        resnorm = jnp.abs(gnew[j + 1])
        k = s.k + 1
        if monitor:
            # inactive lanes (past this cycle's convergence point) repeat
            # the last residual; emit only live steps
            from poissbox_tpu.solvers.cg import emit_monitor
            lax.cond(active,
                     lambda kr: emit_monitor(kr[0], kr[1]) or 0,
                     lambda kr: 0, (k, resnorm))

        updated = _CycleState(
            V=s.V.at[j + 1].set(vnext),
            H=s.H.at[:, j].set(hcol),
            cs=s.cs.at[j].set(csj),
            sn=s.sn.at[j].set(snj),
            g=gnew,
            resnorm=resnorm,
            jdone=j + 1,
            hist=s.hist.at[k].set(resnorm),
            k=k,
        )
        return jax.tree.map(
            lambda new, old: jnp.where(active, new, old), updated, s
        )

    def cycle(outer: _OuterState) -> _OuterState:
        r = pres(b - A(outer.x))
        beta = jnp.sqrt(jnp.sum(r * r))
        V = jnp.zeros((m + 1,) + b.shape, b.dtype)
        V = V.at[0].set(r / jnp.maximum(beta, tiny))
        s0 = _CycleState(
            V=V,
            H=jnp.zeros((m + 1, m), b.dtype),
            cs=jnp.zeros((m,), b.dtype),
            sn=jnp.zeros((m,), b.dtype),
            g=jnp.zeros((m + 1,), b.dtype).at[0].set(beta),
            resnorm=beta,
            jdone=jnp.int32(0),
            hist=outer.hist,
            k=outer.k,
        )
        s = lax.fori_loop(0, m, arnoldi_step, s0)

        # solve the (masked) upper-triangular system H[:m,:m] y = g[:m]
        rows = jnp.arange(m)
        used = rows < s.jdone
        Hm = jnp.where(used[None, :] & used[:, None], s.H[:m, :m], 0.0)
        Hm = Hm + jnp.diag(jnp.where(used, 0.0, 1.0).astype(b.dtype))
        y = jax.scipy.linalg.solve_triangular(Hm, jnp.where(used, s.g[:m], 0.0))
        dx = jnp.tensordot(y, s.V[:m], axes=((0,), (0,)), precision=_HIGHEST)
        x = A.project(outer.x + dx)
        return _OuterState(x, s.resnorm, s.k, s.hist)

    def cond(outer: _OuterState) -> Array:
        not_done = outer.resnorm > target(rnorm0)
        return not_done & jnp.isfinite(outer.resnorm) & (outer.k < max_it)

    final = lax.while_loop(cond, cycle, _OuterState(x, rnorm0, jnp.int32(0), hist))
    reason = classify(final.resnorm, final.k, bnorm, rtol_, atol_, max_it)
    return SolveResult(final.x, final.k, final.resnorm, final.hist, reason)
