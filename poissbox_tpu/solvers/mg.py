"""Geometric multigrid V-cycle preconditioner — the `-pc_type gamg` replacement.

The reference preconditions CG with PETSc's algebraic multigrid (GAMG) using
Richardson+SOR level smoothing and an SVD coarse solve
(`-pc_type gamg -mg_coarse_sub_pc_type svd -mg_levels_ksp_rtol 1.0e-4
-mg_levels_ksp_type richardson -mg_levels_pc_type sor`, reference
README.md:42-47). The grid here is structured and uniform, so the idiomatic
equivalent is *geometric* multigrid:

  * hierarchy: each level halves (nx, ny, nz); operators are re-discretized
    7-point Laplacians (uniform periodic grid — re-discretization and
    Galerkin coarsening agree to the order of the scheme);
  * smoothers: red-black SOR (the parallel-correct SOR ordering — plain
    lexicographic SOR is sequential and has no data-parallel form) or weighted
    Jacobi, both expressed as masked stencil updates that XLA fuses; the
    post-smoother runs colors in reverse (black-red) so one V-cycle is a
    symmetric operator, as CG preconditioning requires;
  * transfers: cell-centered full-weighting restriction and trilinear
    prolongation (the variational pair P = 2 R^T), as reshapes and rolls
    that XLA fuses and GSPMD partitions;
  * coarse solve: dense pseudo-inverse of the assembled coarse Laplacian via
    SVD with the zero singular value (constant null space) truncated —
    exactly the `-mg_coarse_sub_pc_type svd` semantics; computed once at
    setup with numpy and folded into the compiled cycle as a constant.

The whole V-cycle is a pure function of the input residual: levels are a
static Python list, so jit unrolls the cycle into one fused program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from poissbox_tpu.ops.stencil import apply_laplacian

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Multigrid knobs, mirroring the reference's `-mg_*` flag set."""

    levels: int = 0               # 0 = auto (coarsen while divisible, > coarse_size)
    smoother: str = "sor"         # "sor" (red-black) | "jacobi" | "chebyshev"
    # -1 = auto, resolved against the fine-grid size when the
    # preconditioner is built (see _resolve_sweeps: V(1,1) at 512^3-class,
    # V(2,2) at 256^3-class, V(3,3) below — weaker smoothing + more
    # Krylov iterations as the fine-level sweeps grow relative to the CG
    # vector algebra).
    pre_smooth: int = -1          # smoother sweeps before coarse correction
    post_smooth: int = -1         # ... and after (reversed ordering)
    damping: Optional[float] = None  # None = per-smoother default (sor 1.0, jacobi 8/9)
    coarse: str = "svd"           # "svd" | "direct" (both dense; svd truncates nullspace)
    coarse_size: int = 4          # stop coarsening at min(n) <= coarse_size
    cycles: int = 1               # V-cycles per preconditioner application
    # "v" | "w": W revisits sub-fine levels twice per cycle (the second
    # visit corrects the first: e <- e + C(r - A e), which keeps the cycle
    # symmetric: S = 2C - C A C = S^T for symmetric C, A). Coarse levels
    # cost 8x less per level, so a W-cycle adds ~15% to the cycle but
    # strengthens the coarse correction enough to run weaker (cheaper)
    # fine-level smoothing at the same outer iteration count.
    cycle: str = "v"
    # Depth cap on the W doubling: child levels deeper than `w_depth`
    # run plain V. Full W doubles visit counts geometrically (2^depth
    # coarse-solve calls in the unrolled jit graph — slow compiles, and
    # the sub-1% -work levels don't pay back); depth 2 doubles the two
    # largest sub-fine levels, which carry ~97% of the sub-fine work.
    w_depth: int = 2
    # Cycle compute dtype ("" = the field dtype). "bfloat16" halves the
    # memory bytes of every smoother sweep, residual, and transfer — the
    # smoothing passes are bandwidth-bound. The preconditioner stays a fixed linear operator (same cycle every
    # application); bf16 rounding weakens it slightly, typically costing
    # 0-2 extra outer CG iterations — a large net win at 256^3+. The
    # coarse pseudo-inverse solve always runs in the setup dtype.
    dtype: str = ""
    # Pre-smoother compute dtype ("" = the cycle dtype). Unlike `dtype`,
    # "bfloat16" here does NOT quantize the cycle's output: the pre-smooth
    # iterate x1 feeds a full-precision residual r = b - A x1 that accounts
    # for whatever x1 actually is, so its rounding perturbs only the
    # convergence RATE (the error modes left for the coarse grid), not the
    # fixed point — the pre-smooth bytes halve at ~zero iteration cost,
    # where a full-bf16 cycle quantizes the output and stalls plain CG
    # near 5e-6 relative. Post-smoothing stays in the cycle dtype.
    pre_dtype: str = ""


# High-frequency contraction factor per sweep, used to translate the
# reference's level-solve rtol (`-mg_levels_ksp_rtol`, reference
# README.md:43-44) into an equivalent *static* sweep count. In MG the level
# solve only has to damp the modes the coarse grid cannot represent, so the
# smoothing factor (not the full-spectrum solve rate, which is O(1 - h^2))
# is the right contraction: RB-SOR(w=1) on the 3-D 7-point operator ~0.25;
# damped Jacobi near-optimal 3-D damping ~5/7; Chebyshev on the
# [0.1, 1]*lambda_max interval ~0.52 per degree = ~0.27 per 2-degree sweep.
_SMOOTHING_FACTOR = {"sor": 0.25, "jacobi": 5.0 / 7.0, "chebyshev": 0.27}


def sweeps_for_level_rtol(smoother: str, rtol: float, max_it: int) -> int:
    """Static sweep count equivalent to a level solve run to `rtol` capped
    at `max_it` iterations (PETSc stops at whichever binds first).

    Keeping the count static preserves the V-cycle as a fixed linear,
    symmetric operator — required for (non-flexible) CG — while honoring
    the rtol semantics of the reference's solver of record.
    """
    import math

    mu = _SMOOTHING_FACTOR.get(smoother)
    if mu is None:
        raise ValueError(f"unknown smoother {smoother!r}")
    if not (0.0 < rtol < 1.0):
        return max_it
    need = math.ceil(math.log(rtol) / math.log(mu))
    return max(1, min(int(max_it), need))


@dataclasses.dataclass(frozen=True)
class _Level:
    shape: tuple[int, int, int]
    deltas: tuple[float, float, float]
    diag: float                   # constant stencil diagonal -2*sum(1/d^2)
    # grid: non-None when the level runs *distributed* (shard_map halo
    # exchanges around per-device kernels); None = level runs replicated /
    # single-device. mesh: the device mesh when the whole hierarchy lives
    # on one (used to pin replicated coarse levels).
    grid: Optional[object] = None
    mesh: Optional[object] = None


def _is_uneven(lvl: _Level) -> bool:
    return lvl.grid is not None and getattr(lvl.grid, "uneven", False)


def _lapl(x: Array, lvl: _Level, cfg: MGConfig) -> Array:
    """Level-operator application: distributed correction-form on sharded
    levels, XLA rolls else."""
    if _is_uneven(lvl):
        from poissbox_tpu.parallel.uneven import apply_laplacian_uneven
        return apply_laplacian_uneven(x, lvl.grid)
    if lvl.grid is not None:
        from poissbox_tpu.parallel.dist_stencil import apply_laplacian_sharded
        return apply_laplacian_sharded(x, lvl.grid)
    return apply_laplacian(x, lvl.deltas)


def _residual(x: Array, b: Array, lvl: _Level, cfg: MGConfig) -> Array:
    if _is_uneven(lvl):
        from poissbox_tpu.parallel.uneven import residual_uneven
        return residual_uneven(x, b, lvl.grid)
    if lvl.grid is not None:
        from poissbox_tpu.parallel.dist_stencil import residual_sharded
        return residual_sharded(x, b, lvl.grid)
    return b - apply_laplacian(x, lvl.deltas)


def _level_shardable(n, grid) -> bool:
    """A level stays distributed while every sharded dim keeps an even
    local extent (even device offsets keep red-black parity locally
    computable; see dist_stencil.sor_parity_local_ok)."""
    if grid is None or grid.mesh is None or grid.mesh.size == 1:
        return False
    for nd, name in zip(n, grid.axis_names):
        p = grid.mesh.shape[name]
        if p > 1 and (nd % p != 0 or (nd // p) % 2 != 0):
            return False
    return True


def _build_levels(shape, deltas, cfg: MGConfig, grid=None) -> list[_Level]:
    import dataclasses as _dc

    levels = []
    n = tuple(shape)
    d = tuple(float(x) for x in deltas)
    mesh = getattr(grid, "mesh", None)
    if mesh is not None and mesh.size == 1:
        mesh = None
    uneven_fine = (mesh is not None and grid is not None
                   and getattr(grid, "uneven", False))
    while True:
        diag = -2.0 * sum(1.0 / dd**2 for dd in d)
        lgrid = None
        if uneven_fine and not levels:
            # non-divisible decomposition: the fine level runs distributed
            # in the padded layout; coarser levels run replicated — the
            # GAMG-style process-count reduction, here taken at level 1
            lgrid = grid
        elif mesh is not None and _level_shardable(n, grid):
            lgrid = _dc.replace(grid, n=n)
        levels.append(_Level(n, d, diag, grid=lgrid, mesh=mesh))
        stop_size = min(n) <= cfg.coarse_size
        stop_div = any(x % 2 for x in n)
        stop_count = cfg.levels > 0 and len(levels) >= cfg.levels
        if stop_size or stop_div or stop_count:
            return levels
        n = tuple(x // 2 for x in n)
        d = tuple(2.0 * dd for dd in d)


# ---------------------------------------------------------------------------
# transfers (cell-centered, periodic)
# ---------------------------------------------------------------------------

def restrict(f: Array) -> Array:
    """Full-weighting restriction for cell-centered grids: R = P^T / 8,
    the exact (scaled) adjoint of :func:`prolong` — the variational pairing
    that keeps the V-cycle a symmetric operator (CG requires it).

    Along each axis: c_I = (3 f_{2I} + 3 f_{2I+1} + f_{2I+2} + f_{2I-1}) / 8,
    periodic.
    """
    for ax in range(f.ndim):
        n = f.shape[ax]
        pairs = f.reshape(f.shape[:ax] + (n // 2, 2) + f.shape[ax + 1:])
        even = jnp.take(pairs, 0, axis=ax + 1)   # f_{2I}
        odd = jnp.take(pairs, 1, axis=ax + 1)    # f_{2I+1}
        up = jnp.roll(even, -1, ax)              # f_{2I+2}
        dn = jnp.roll(odd, 1, ax)                # f_{2I-1}
        f = (3.0 * (even + odd) + up + dn) * 0.125
    return f


def prolong(c: Array) -> Array:
    """Trilinear prolongation for cell-centered grids.

    Along each axis a fine cell at i = 2I + s interpolates 3/4 from its
    parent and 1/4 from the parent's (periodic) neighbor on side s.
    """
    for ax in range(c.ndim):
        even = 0.75 * c + 0.25 * jnp.roll(c, 1, ax)    # fine i = 2I
        odd = 0.75 * c + 0.25 * jnp.roll(c, -1, ax)    # fine i = 2I + 1
        c = jnp.stack([even, odd], axis=ax + 1)
        c = c.reshape(c.shape[:ax] + (c.shape[ax] * 2,) + c.shape[ax + 2:])
    return c


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------

def _color_mask(shape, dtype) -> Array:
    """Red mask: (i + j + k) even. Static per level; folded into the kernel."""
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    return (((ii + jj + kk) % 2) == 0).astype(dtype)


def _smooth(x: Optional[Array], b: Array, lvl: _Level, cfg: MGConfig,
            sweeps: int, reverse: bool):
    """`sweeps` smoothing iterations of the level operator.

    This is the Richardson-with-SOR/Jacobi level solve of the reference's MG
    configuration (reference README.md:43-47), with fixed sweep count in
    place of the inner rtol (fixed iteration counts keep the cycle a linear,
    symmetric operator — required for CG — and compile to straight-line
    code).

    `x=None` means a zero initial guess (the V-cycle's pre-smooth): the
    first partial update is evaluated in closed form (A·0 = 0), saving one
    full stencil pass — and, distributed, one halo exchange — per level
    per cycle.
    """
    if sweeps < 0:
        raise ValueError(
            "pre/post_smooth=-1 (auto) is resolved by make_mg_preconditioner;"
            " pass explicit sweep counts when calling v_cycle directly")
    if sweeps == 0:
        # pre_smooth=0 / post_smooth=0 must be exact no-ops (zero guess
        # included), or the cycle loses its transpose pairing
        return jnp.zeros_like(b) if x is None else x
    inv_diag = 1.0 / lvl.diag
    dist = lvl.grid is not None
    if cfg.smoother == "jacobi":
        w = 8.0 / 9.0 if cfg.damping is None else cfg.damping
        if x is None:
            x = (w * inv_diag) * b      # first sweep from zero, closed form
            sweeps -= 1
        if dist:
            if _is_uneven(lvl):
                from poissbox_tpu.parallel.uneven import jacobi_sweep_uneven
                for _ in range(sweeps):
                    x = jacobi_sweep_uneven(x, b, lvl.grid, w)
                return x
            from poissbox_tpu.parallel.dist_stencil import jacobi_sweep_sharded
            for _ in range(sweeps):
                x = jacobi_sweep_sharded(x, b, lvl.grid, w)
            return x
        for _ in range(sweeps):
            x = x + w * inv_diag * (b - apply_laplacian(x, lvl.deltas))
        return x
    if cfg.smoother == "chebyshev":
        # Chebyshev polynomial smoothing (PETSc GAMG's modern default level
        # solver, `-mg_levels_ksp_type chebyshev`). The periodic 7-point
        # spectrum is known analytically — eigenvalues in [-4*sum(1/d^2), 0]
        # — so the usual power-iteration estimate is unnecessary; smooth the
        # upper 90% of the spectrum ([0.1, 1.0]*lambda_max in magnitude,
        # GAMG's convention). A polynomial in A is symmetric by
        # construction, so pre/post ordering needs no reversal.
        m = 4.0 * sum(1.0 / dd**2 for dd in lvl.deltas)
        a_lo, b_hi = -m, -0.1 * m          # signed spectrum interval
        theta = 0.5 * (a_lo + b_hi)
        delta = 0.5 * (b_hi - a_lo)
        sigma1 = theta / delta
        degree = max(2 * sweeps, 2)        # ~cost parity with 2-color SOR
        if x is None:                      # zero guess: r = b, closed form
            d = b / theta
            x = d
        else:
            r = _residual(x, b, lvl, cfg)
            d = r / theta
            x = x + d
        rho = 1.0 / sigma1
        for _ in range(degree - 1):
            r = _residual(x, b, lvl, cfg)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            x = x + d
            rho = rho_new
        return x
    if cfg.smoother == "sor":
        w = 1.0 if cfg.damping is None else cfg.damping
        order = [1, 0] if reverse else [0, 1]  # color 0 = red, (i+j+k) even
        half = False
        if x is None:
            # first color from zero in closed form (one elementwise pass),
            # leaving the sweep's second color to the stencil kernels
            if _is_uneven(lvl):
                from poissbox_tpu.parallel.uneven import color_mask
                m0 = color_mask(lvl.grid, order[0], b.dtype)
            else:
                red = _color_mask(lvl.shape, b.dtype)
                m0 = red if order[0] == 0 else 1.0 - red
            x = (w * inv_diag) * m0 * b
            half = True
        if dist:
            if _is_uneven(lvl):
                from poissbox_tpu.parallel.uneven import sor_sweep_uneven
                if half:
                    x = sor_sweep_uneven(x, b, lvl.grid, w, order[1])
                    sweeps -= 1
                for _ in range(sweeps):
                    for color in order:
                        x = sor_sweep_uneven(x, b, lvl.grid, w, color)
                return x
            from poissbox_tpu.parallel.dist_stencil import sor_sweep_sharded
            if half:
                x = sor_sweep_sharded(x, b, lvl.grid, w, order[1])
                sweeps -= 1
            for _ in range(sweeps):
                for color in order:
                    x = sor_sweep_sharded(x, b, lvl.grid, w, color)
            return x
        red = _color_mask(lvl.shape, b.dtype)
        masks = {0: red, 1: 1.0 - red}
        if half:
            r = b - apply_laplacian(x, lvl.deltas)
            x = x + (w * inv_diag) * masks[order[1]] * r
            sweeps -= 1
        for _ in range(sweeps):
            for color in order:
                r = b - apply_laplacian(x, lvl.deltas)
                x = x + (w * inv_diag) * masks[color] * r
        return x
    raise ValueError(f"unknown smoother {cfg.smoother!r} (expected sor|jacobi|chebyshev)")


# ---------------------------------------------------------------------------
# coarse solve
# ---------------------------------------------------------------------------

def _dense_periodic_laplacian(shape, deltas) -> np.ndarray:
    """Assemble the coarse 7-point periodic Laplacian densely (numpy, setup
    time). Kronecker structure: A = Lx (x) Iy (x) Iz + ... ."""
    def l1d(n, d):
        L = np.zeros((n, n))
        idx = np.arange(n)
        L[idx, idx] = -2.0
        L[idx, (idx + 1) % n] = 1.0
        L[idx, (idx - 1) % n] = 1.0
        return L / d**2

    nx, ny, nz = shape
    dx, dy, dz = deltas
    Ix, Iy, Iz = np.eye(nx), np.eye(ny), np.eye(nz)
    A = (
        np.kron(np.kron(l1d(nx, dx), Iy), Iz)
        + np.kron(np.kron(Ix, l1d(ny, dy)), Iz)
        + np.kron(np.kron(Ix, Iy), l1d(nz, dz))
    )
    return A


def _coarse_pinv(lvl: _Level, cfg: MGConfig, dtype) -> Array:
    """SVD pseudo-inverse of the coarse operator, nullspace truncated —
    the `-mg_coarse_sub_pc_type svd` coarse solve."""
    A = _dense_periodic_laplacian(lvl.shape, lvl.deltas)
    if cfg.coarse not in ("svd", "direct"):
        raise ValueError(f"unknown coarse solve {cfg.coarse!r}")
    # rcond cuts the zero singular value of the singular periodic operator;
    # "direct" on this singular system is the same least-squares solve.
    pinv = np.linalg.pinv(A, rcond=1e-10)
    return jnp.asarray(pinv, dtype)


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------

def _pin(x: Array, lvl: _Level) -> Array:
    """Pin an array to the level's placement: its grid sharding when the
    level runs distributed, explicit replication on the mesh otherwise —
    the deterministic level-transition reshard (coarse levels gather to
    replicated once too small to shard)."""
    if lvl.mesh is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec
    sh = (lvl.grid.sharding if lvl.grid is not None
          else NamedSharding(lvl.mesh, PartitionSpec()))
    return jax.lax.with_sharding_constraint(x, sh)


def _coarse_correct(levels: Sequence[_Level], coarse_pinv: Array,
                    cfg: MGConfig, rc: Array, cidx: int) -> Array:
    """Child-level correction for the restricted residual: one recursive
    cycle, or two in W-cycle mode (second visit corrects the first —
    e <- e + C(rc - A e) — which doubles every sub-fine level's visit
    count, the classical W recursion)."""
    ec = v_cycle(levels, coarse_pinv, cfg, rc, cidx)
    if cfg.cycle == "w" and cidx <= cfg.w_depth and cidx < len(levels) - 1:
        r2 = rc - _lapl(ec, levels[cidx], cfg)
        ec = ec + v_cycle(levels, coarse_pinv, cfg, r2, cidx)
    elif cfg.cycle not in ("v", "w"):
        raise ValueError(f"unknown cycle {cfg.cycle!r} (expected v|w)")
    return ec


def v_cycle(levels: Sequence[_Level], coarse_pinv: Array, cfg: MGConfig,
            b: Array, idx: int = 0) -> Array:
    """One V-cycle for the level-`idx` system A_idx e = b. Pure; levels are
    static so jit unrolls the recursion."""
    lvl = levels[idx]
    if idx == len(levels) - 1:
        # coarse solve in the pinv's (setup) precision regardless of the
        # cycle dtype; cast back so the upward sweep stays uniform.
        # HIGHEST: an f32 matmul may otherwise run in TF32 (~3 digits)
        flat = b.reshape(-1).astype(coarse_pinv.dtype)
        x = jnp.matmul(coarse_pinv, flat, precision=jax.lax.Precision.HIGHEST)
        return x.reshape(lvl.shape).astype(b.dtype)
    pd = jnp.dtype(cfg.pre_dtype) if cfg.pre_dtype else None
    if pd is not None and pd != b.dtype:
        # low-precision pre-smooth: x1's rounding is fully absorbed by the
        # full-precision residual below (see MGConfig.pre_dtype)
        x = _smooth(None, b.astype(pd), lvl, cfg, cfg.pre_smooth,
                    reverse=False).astype(b.dtype)
    else:
        x = _smooth(None, b, lvl, cfg, cfg.pre_smooth, reverse=False)
    r = _residual(x, b, lvl, cfg)
    if _is_uneven(lvl):
        # padded fine level -> replicated unpadded coarse level: gather the
        # valid cells, restrict, correct, prolong, scatter back (pads zero)
        from poissbox_tpu.parallel import uneven as _ue
        rc = _pin(restrict(_ue.from_padded(r, lvl.grid)), levels[idx + 1])
        ec = _coarse_correct(levels, coarse_pinv, cfg, rc, idx + 1)
        x = x + _pin(_ue.to_padded(prolong(ec), lvl.grid), lvl)
    else:
        rc = _pin(restrict(r), levels[idx + 1])
        ec = _coarse_correct(levels, coarse_pinv, cfg, rc, idx + 1)
        x = x + _pin(prolong(ec), lvl)
    return _smooth(x, b, lvl, cfg, cfg.post_smooth, reverse=True)


def _resolve_sweeps(cfg: MGConfig, shape: Sequence[int]) -> MGConfig:
    """Resolve pre/post_smooth = -1 (auto) against the fine-grid size:

      512^3-class  V(1,1)
      256^3-class  V(2,2)
      <= 128^3     V(3,3) — the stronger cycle preserves the
                   reference-calibrated iteration counts

    The fine-level sweeps get more expensive relative to the CG vector
    algebra as the grid grows, so the optimum shifts toward weaker
    smoothing + more Krylov iterations (PERF.md records the V(1,1) vs
    V(2,2) comparison at 512^3). Explicit values pass through."""
    if cfg.pre_smooth >= 0 and cfg.post_smooth >= 0:
        return cfg
    auto = 1 if min(shape) >= 512 else (2 if min(shape) >= 256 else 3)
    return dataclasses.replace(
        cfg,
        pre_smooth=cfg.pre_smooth if cfg.pre_smooth >= 0 else auto,
        post_smooth=cfg.post_smooth if cfg.post_smooth >= 0 else auto)


def make_mg_preconditioner(
    shape: Sequence[int],
    deltas: Sequence[float],
    cfg: MGConfig = MGConfig(),
    dtype=jnp.float64,
    grid=None,
) -> Callable[[Array], Array]:
    """Build M(r) ~= A^{-1} r, a jit-compatible V-cycle closure.

    Setup (hierarchy + dense coarse pseudo-inverse) runs once here; the
    returned closure is linear and symmetric, suitable as a CG
    preconditioner. Pass `grid` (a meshed Grid3D) to run the fine levels
    distributed — shard_map halo exchanges around per-device kernels, with
    coarse levels replicated once they are too small to shard (the
    analogue of GAMG's process-count reduction on coarse grids).
    """
    cfg = _resolve_sweeps(cfg, shape)
    if (not cfg.pre_dtype and not cfg.dtype and min(shape) >= 512
            and jnp.dtype(dtype) == jnp.float32):
        # 512^3-class default: bf16 pre-smooth (the pre-smooth bytes
        # halve; the full-precision residual absorbs the rounding, so the
        # iteration count is unchanged; PERF.md records the on/off
        # comparison at 512^3). Opt out with pre_dtype="float32" (an
        # explicit no-op dtype).
        cfg = dataclasses.replace(cfg, pre_dtype="bfloat16")
    levels = _build_levels(tuple(shape), tuple(deltas), cfg, grid=grid)
    pinv = _coarse_pinv(levels[-1], cfg, dtype)
    cdt = jnp.dtype(cfg.dtype) if cfg.dtype else None

    def M(r: Array) -> Array:
        rin = r.astype(cdt) if cdt is not None else r
        x = v_cycle(levels, pinv, cfg, rin)
        for _ in range(cfg.cycles - 1):
            x = x + v_cycle(levels, pinv, cfg, rin - _lapl(x, levels[0], cfg))
        return x.astype(r.dtype)

    # resolved configuration, introspectable (tests assert the cycle shape
    # an entry point actually built — e.g. V(2,2) at 256^3-class grids)
    M.config = cfg
    return M
