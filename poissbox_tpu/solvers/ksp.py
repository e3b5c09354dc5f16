"""Options-driven solver dispatch — the KSPSetFromOptions / KSPSolve analog.

The reference wires solver choice entirely through the options database:
`KSPCreate` + `KSPSetOperators` + `KSPSetFromOptions` + `KSPSolve`
(reference src/poissbox.f90:293-296), configured by `-ksp_*`/`-pc_*`/`-mg_*`
flags (reference README.md:42-49). :func:`make_solver` assembles the same
pipeline from a :class:`SolverOptions`: preconditioner construction
(none/jacobi/mg), Krylov method selection (cg/fcg/gmres/richardson), stopping
controls, and monitor output.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from poissbox_tpu.config import Options, SolverOptions
from poissbox_tpu.linops import LinearOperator
from poissbox_tpu.solvers.cg import cg
from poissbox_tpu.solvers.gmres import gmres
from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner
from poissbox_tpu.solvers.result import SolveResult
from poissbox_tpu.solvers.richardson import richardson

Array = jax.Array


def make_preconditioner(
    A: LinearOperator,
    opts: SolverOptions,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    dtype=jnp.float64,
    grid=None,
) -> Optional[Callable[[Array], Array]]:
    """Build the preconditioner closure selected by `pc_type`."""
    if opts.pc_type in ("none", ""):
        return None
    if opts.pc_type == "jacobi":
        if A.diagonal is None:
            raise ValueError("jacobi preconditioning needs an operator diagonal")
        inv_diag = 1.0 / A.diagonal()
        return lambda r: inv_diag * r
    if opts.pc_type == "fft":
        # exact periodic 7-point inverse as a spectrally-equivalent
        # preconditioner (for the compact 6th-order system, variable
        # coefficients, ...); distributed via pencil FFTs on meshed grids
        if grid is not None:
            deltas = grid.deltas if deltas is None else deltas
        if deltas is None:
            raise ValueError("fft preconditioning needs the grid deltas")
        from poissbox_tpu.solvers.fft import make_fft_preconditioner
        return make_fft_preconditioner(deltas, grid=grid)
    if opts.pc_type == "mg":
        if shape is None or deltas is None:
            raise ValueError("mg preconditioning needs the grid shape and deltas")
        smoother = opts.mg_levels_pc_type
        if opts.mg_levels_ksp_type == "chebyshev":
            # PETSc expresses Chebyshev as the level KSP type
            smoother = "chebyshev"
        # `-mg_levels_ksp_rtol` semantics: the level solve stops at rtol or
        # max_it, whichever binds first — statically calibrated to a fixed
        # sweep count via the smoother's smoothing factor (see
        # solvers.mg.sweeps_for_level_rtol). When NEITHER flag is given,
        # pass the -1 auto sentinel through so solvers.mg._resolve_sweeps
        # picks the size-aware optimum — the options entry point and
        # MGConfig() then build the same cycle (one solver of record,
        # reference README.md:42-47).
        from poissbox_tpu.solvers.mg import sweeps_for_level_rtol
        rtol_set = opts.mg_levels_ksp_rtol > 0.0
        max_set = opts.mg_levels_ksp_max_it >= 0
        if rtol_set or max_set:
            lv_rtol = opts.mg_levels_ksp_rtol if rtol_set else 1.0e-4
            lv_max = opts.mg_levels_ksp_max_it if max_set else 3
            sweeps = sweeps_for_level_rtol(smoother, lv_rtol, lv_max)
        else:
            sweeps = -1  # size-aware auto
        if (opts.mg_cycle_dtype == "bfloat16" and opts.ksp_rtol < 1e-5
                and opts.ksp_type != "fcg"):
            # a bf16 V-cycle's output noise floor stalls the
            # FLETCHER-REEVES recursion near ~5e-6 relative — the solve
            # then spins to max_it without converging. Flexible CG's
            # Polak-Ribiere beta stays convergent, so fcg is exempt; plain
            # cg+bf16 is for loose tolerances or refinement inner solves.
            import warnings
            warnings.warn(
                f"mg_cycle_dtype=bfloat16 with ksp_rtol={opts.ksp_rtol:g}: "
                "bf16 preconditioner noise stalls CG near 5e-6 relative; "
                "use -ksp_type fcg, ksp_rtol >= 1e-5, or solve_refined",
                stacklevel=2)
        cfg = MGConfig(
            levels=opts.mg_levels,
            smoother=smoother,
            pre_smooth=sweeps,
            post_smooth=sweeps,
            damping=None if opts.mg_levels_damping == 1.0
            and opts.mg_levels_pc_type == "jacobi" else opts.mg_levels_damping,
            coarse=opts.mg_coarse_pc_type,
            cycles=opts.mg_cycles,
            cycle=opts.mg_cycle,
            dtype=opts.mg_cycle_dtype,
            pre_dtype=opts.mg_pre_dtype,
        )
        return make_mg_preconditioner(shape, deltas, cfg, dtype, grid=grid)
    raise ValueError(
        f"unknown pc_type {opts.pc_type!r} (expected none|jacobi|fft|mg)")


def make_solver(
    A: LinearOperator,
    opts: SolverOptions | Options | None = None,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    dtype=jnp.float64,
    grid=None,
) -> Callable[[Array], SolveResult]:
    """Assemble a jit-compatible `solve(b) -> SolveResult` closure."""
    if opts is None:
        opts = SolverOptions()
    elif isinstance(opts, Options):
        opts = SolverOptions.from_options(opts)

    # direct solvers take no preconditioner — skip the (possibly
    # expensive) MG setup entirely
    if grid is not None:
        shape = grid.n if shape is None else shape
        deltas = grid.deltas if deltas is None else deltas
    M = (None if opts.ksp_type == "fft"
         else make_preconditioner(A, opts, shape, deltas, dtype, grid=grid))
    common = dict(M=M, rtol=opts.ksp_rtol, atol=opts.ksp_atol,
                  max_it=opts.ksp_max_it)

    def _attach(fn):
        # expose the built preconditioner + config for `-ksp_view`
        fn.M = M
        fn.opts = opts
        fn.shape = tuple(shape) if shape is not None else None
        return fn

    if opts.ksp_type in ("cg", "fcg"):
        # fcg = flexible CG (PETSc KSPFCG): Polak-Ribiere beta, robust to
        # nonstationary preconditioners (bf16 V-cycles, inner Krylov)
        return _attach(lambda b, x0=None: cg(A, b, x0, norm_type=opts.ksp_norm_type,
                                     flexible=opts.ksp_type == "fcg",
                                     monitor=opts.ksp_monitor,
                                     **common))
    if opts.ksp_type == "pipecg":
        # single overlapped reduction per iteration (PETSc KSPPIPECG);
        # for meshes where psum latency dominates — see solvers/pipecg.py
        from poissbox_tpu.solvers.pipecg import pipecg
        return _attach(lambda b, x0=None: pipecg(A, b, x0,
                                         norm_type=opts.ksp_norm_type,
                                         monitor=opts.ksp_monitor,
                                         **common))
    if opts.ksp_type == "gmres":
        return _attach(lambda b, x0=None: gmres(
            A, b, x0, restart=opts.gmres_restart,
            monitor=opts.ksp_monitor, **common))
    if opts.ksp_type == "richardson":
        return _attach(lambda b, x0=None: richardson(
            A, b, x0, monitor=opts.ksp_monitor, **common))
    if opts.ksp_type == "fft":
        if deltas is None:
            raise ValueError("fft direct solve needs the grid deltas")
        from poissbox_tpu.solvers.fft import fft_solver_result
        return _attach(lambda b, x0=None: fft_solver_result(
            A, b, deltas, grid=grid))
    raise ValueError(
        f"unknown ksp_type {opts.ksp_type!r} "
        "(expected cg|fcg|pipecg|gmres|richardson|fft)")


def view(opts: SolverOptions, shape=None, M=None) -> str:
    """`-ksp_view`-style description of the assembled solver configuration
    (PETSc prints this from KSPView before the solve; reference solver of
    record: README.md:42-47). The MG block reports the RESOLVED cycle —
    the size-aware auto sweep counts and the actual level stack — not the
    raw flags."""
    lines = [
        "KSP Object:",
        f"  type: {opts.ksp_type}",
        f"  norm type: {opts.ksp_norm_type}",
        f"  tolerances: rtol={opts.ksp_rtol:g}, atol={opts.ksp_atol:g}, "
        f"max_it={opts.ksp_max_it}",
    ]
    if opts.ksp_type == "gmres":
        lines.append(f"  restart: {opts.gmres_restart}")
    lines.append("PC Object:")
    lines.append(f"  type: {opts.pc_type}")
    cfg = getattr(M, "config", None)
    if opts.pc_type == "mg" and cfg is not None:
        from poissbox_tpu.solvers.mg import _build_levels
        lines += [
            f"  cycle: {cfg.cycle.upper()}({cfg.pre_smooth},"
            f"{cfg.post_smooth}) x{cfg.cycles}",
            f"  smoother: {cfg.smoother}"
            + (f" (damping {cfg.damping:g})" if cfg.damping else ""),
            f"  coarse solve: {cfg.coarse}",
        ]
        if cfg.dtype or cfg.pre_dtype:
            lines.append(f"  cycle dtype: {cfg.dtype or 'field'}"
                         f" / pre-smooth {cfg.pre_dtype or 'cycle'}")
        if shape is not None:
            levels = _build_levels(tuple(shape), (1.0,) * 3, cfg)
            lines.append(
                "  levels: "
                + " -> ".join("x".join(map(str, lv.shape)) for lv in levels))
    return "\n".join(lines)


def _print_log_view(A: LinearOperator, b: Array, M, result,
                    t_setup: float, t_solve: float) -> None:
    """`-log_view` analogue: PETSc's per-event performance summary
    (count, time/call, total, fraction), adapted to the jit model.

    Inside one fused jitted loop the events cannot be instrumented
    individually, so each event's time/call is MEASURED standalone (jitted,
    warmed, host clock around `block_until_ready`) and multiplied by its
    count. The residual vs the solve wall is the fusion/overlap gain or
    loop overhead.
    """
    from poissbox_tpu.utils.profiling import kernel_time

    it = max(int(result.iterations), 1)
    events = [("MatMult", it + 1, kernel_time(A.apply, b))]
    if M is not None:
        events.append(("PCApply", it, kernel_time(M, b)))
    ndof = b.size
    print("log_view: event        count   time/call        total   %solve")
    accounted = 0.0
    for name, count, tc in events:
        tot = count * tc
        accounted += tot
        print(f"log_view:   {name:<10} {count:5d}   {tc * 1e3:9.3f} ms"
              f"   {tot:8.4f} s   {100.0 * tot / max(t_solve, 1e-12):5.1f}%")
    rest = t_solve - accounted
    print(f"log_view:   {'other':<10} {'':5}   {'':12}"
          f"   {rest:8.4f} s   {100.0 * rest / max(t_solve, 1e-12):5.1f}%"
          "  (vector algebra, reductions, fusion/overlap delta)")
    print(f"log_view:   {'setup':<10} {1:5d}   {'':12}   {t_setup:8.4f} s")
    print(f"log_view:   {'solve':<10} {1:5d}   {'':12}   {t_solve:8.4f} s"
          f"   ({int(result.iterations)} iterations, "
          f"{t_solve / it * 1e3:.3f} ms/it, "
          f"{ndof * it / max(t_solve, 1e-12) / 1e9:.2f} GDoF/s)")


def solve(
    A: LinearOperator,
    b: Array,
    opts: SolverOptions | Options | None = None,
    x0: Optional[Array] = None,
    shape: Optional[Sequence[int]] = None,
    deltas: Optional[Sequence[float]] = None,
    grid=None,
) -> SolveResult:
    """One-shot options-driven solve (KSPSolve analogue).

    Prints `-ksp_monitor` / `-ksp_converged_reason` style output when those
    flags are set (reference README.md:48-49).
    """
    db = opts if isinstance(opts, Options) else None
    if isinstance(opts, Options):
        opts = SolverOptions.from_options(opts)
    opts = opts or SolverOptions()
    log_view = db is not None and db.get_bool("log_view")
    import time as _time
    t_setup0 = _time.perf_counter()
    solver = make_solver(A, opts, shape, deltas, b.dtype, grid=grid)
    t_setup = _time.perf_counter() - t_setup0
    # jit the WHOLE solve: an eager call still compiles the Krylov
    # while-loop, but dispatches the setup algebra op by op — on a
    # multi-device mesh every eager sharded op costs a GSPMD compile
    # (measured: the 32^3 demo solve on the 8-device CPU mesh ran minutes
    # eagerly, seconds jitted). SolveResult is a pure array pytree.
    if x0 is None:
        jsolver = jax.jit(lambda bb: solver(bb))
    else:
        jsolver = jax.jit(lambda bb, xx: solver(bb, xx))
    if opts.ksp_view:
        # `-ksp_view`: the assembled solver configuration, with the MG
        # cycle as RESOLVED (auto sweep counts, level stack), before the
        # solve — PETSc's KSPView placement
        print(view(opts, shape if shape is not None else
                   getattr(solver, "shape", None), getattr(solver, "M", None)))
    t0 = _time.perf_counter()
    result = jsolver(b) if x0 is None else jsolver(b, x0)
    jax.block_until_ready(result.x)
    t_solve = _time.perf_counter() - t0
    if log_view:
        # re-run once so the reported solve wall is WARM (the first call
        # above paid the compile); monitors already streamed, and the
        # solve is deterministic, so the result is identical
        t0 = _time.perf_counter()
        jax.block_until_ready(jsolver(b) if x0 is None else jsolver(b, x0))
        t_solve = _time.perf_counter() - t0
        _print_log_view(A, b, getattr(solver, "M", None), result,
                        t_setup, t_solve)
    if db is not None and (db.get_bool("options_left")
                           or db.get_bool("options_error_if_unused")):
        # `-options_left` semantics: after solver assembly, complain about
        # set-but-unconsumed options (PETSc prints this at finalize;
        # reference src/poissbox.f90:295 wires everything through the DB)
        db.check_unused()
    if opts.ksp_monitor and opts.ksp_type == "fft":
        # every iterative solver streams live from inside its jitted loop
        # (solvers.cg.emit_monitor); the direct solve has no iterations —
        # print its one-line residual history post-hoc
        for line in result.monitor_lines():
            print(line)
    if opts.ksp_converged_reason:
        r = result.reason_enum()
        print(f"Linear solve {r.message} (reason {r.name}, "
              f"iterations {int(result.iterations)})")
    return result
