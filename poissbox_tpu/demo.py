"""End-to-end demo — the `poissbox_demo` analogue.

Reproduces the reference demo's narrative (reference src/example.f90:9-88):
device report, grid + operator setup, random solution, matvec self-checks,
options-driven solve, and the final true-residual print — with the
reference's runtime self-checks executed as real assertions:

  * check_grid ......... per-device DoF counts sum to the global DoF
                         (reference src/example.f90:92-116)
  * check_lapl ......... matrix-free matvec == pointwise stencil formulation
                         (reference src/example.f90:201-233)
  * check_matrices ..... all operator implementations agree, ||A x - P x||
                         (reference src/example.f90:235-261)

Grid size and solver are runtime options (the reference hardcodes 64^3 and
reads solver flags from the PETSc options DB, reference src/example.f90:24-35,
README.md:42-49):

    python -m poissbox_tpu.demo -n 64 -ksp_type cg -pc_type mg \
        -ksp_rtol 1e-8 -ksp_monitor -ksp_converged_reason
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp

from poissbox_tpu.config import Options, SolverOptions
from poissbox_tpu.mesh import Grid3D
from poissbox_tpu.ops.stencil import (
    apply_laplacian_pointwise,
    make_laplacian_operator,
)
from poissbox_tpu.solvers.ksp import solve


class DemoReport(NamedTuple):
    rel_residual: float   # final relative true residual ||Ax - b|| / ||b||
    iterations: int
    reason: int           # PETSc-style converged reason (> 0 converged)


def run(opts: Options) -> DemoReport:
    """Run the demo; returns the final relative true residual, the
    iteration count and the converged reason."""
    n = opts.get_int("n", 64)
    platform = opts.get_str("platform", "")
    if platform:  # e.g. `-platform cpu` / `--platform cpu`
        jax.config.update("jax_platforms", platform)
        if platform == "cpu":
            # raises RuntimeError once the backends are initialized
            jax.config.update("jax_num_cpu_devices",
                              opts.get_int("devices", 8))
        # a request that cannot be honoured must not run the demo on
        # another device
        got = jax.devices()[0].platform
        if got != {"cuda": "gpu", "rocm": "gpu"}.get(platform, platform):
            raise RuntimeError(
                f"-platform {platform} requested, but JAX runs on {got}")
    # The reference's numeric policy is double precision everywhere
    # (pb_dp = kind(0.0d0), reference src/constants.f90:15) — the demo
    # honors it on every backend: x64 is the default. `-x64 0` opts into
    # the fast f32 path; an f32-unreachable rtol is then CLAMPED to the
    # dtype-reachable value with an explicit notice instead of silently
    # spinning to DIVERGED_MAX_IT.
    use_x64 = opts.get_bool("x64", True)
    if use_x64 and not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    rtol_clamped = False
    if not use_x64 and opts.get_float("ksp_rtol", 1.0e-5) < 1.0e-6:
        requested_rtol = opts.get_float("ksp_rtol", 1.0e-5)
        opts.set("ksp_rtol", "1e-6")
        rtol_clamped = True
        print(f"NOTICE: -ksp_rtol {requested_rtol:g} is below f32 reach; "
              "clamped to 1e-6 (run with -x64 1 — the default — for the "
              "reference's f64 verification)")

    devices = jax.devices()
    print(f"poissbox_tpu demo: {len(devices)} device(s), "
          f"platform={devices[0].platform}, x64={jax.config.jax_enable_x64}")

    # -- grid (reference example.f90:24-35, 55) ----------------------------
    grid = Grid3D((n, n, n)).with_mesh()
    print(f"grid {n}^3 = {grid.ndof} DoF, deltas={grid.deltas}")

    # check_grid: DoF conservation across the decomposition
    counts = grid.dof_counts()
    assert sum(counts) == grid.ndof, (counts, grid.ndof)
    print(f"DoF distribution over {len(counts)} device(s): {counts} (sum ok)")

    # check_linear_system analogue: per-device owned boxes tile the domain
    # (reference src/example.f90:118-152)
    if grid.mesh is not None:
        from poissbox_tpu.parallel.decomp import owned_boxes
        pgrid = tuple(grid.mesh.shape[name] for name in grid.axis_names)
        boxes = owned_boxes(grid.n, pgrid)
        covered = sum(xn * yn * zn for (_, (xn, yn, zn)) in boxes.values())
        assert covered == grid.ndof
        print(f"ownership: process grid {pgrid}, {len(boxes)} boxes tile the domain (sum ok)")

    # -- operator + fields (reference example.f90:58-72) -------------------
    A = make_laplacian_operator(grid)
    key = jax.random.PRNGKey(opts.get_int("seed", 2026))
    x_exact = A.project(grid.random(key))      # random in [-1, 1], mean-free
    b = A(x_exact)

    # check_lapl: matvec vs independent pointwise formulation. The delta is
    # printed WITH its scale and tolerance: the raw 2-norm grows as
    # eps/dx^2 * sqrt(ndof), so an absolute number (e.g. 4e-2 at 256^3 f32)
    # reads like a failure when it is rounding noise.
    delta = float(jnp.linalg.norm(
        (b - apply_laplacian_pointwise(x_exact, grid.deltas)).ravel()))
    tol = 1000 * float(jnp.finfo(b.dtype).eps)
    b_scale = float(jnp.linalg.norm(b.ravel()))
    bound = tol * b_scale + tol
    ok = delta < bound
    print(f"check_lapl: ||matvec - pointwise||_2 = {delta:.3e} "
          f"(relative {delta / b_scale:.3e}, tol {bound:.3e} "
          f"= 1000*eps*||b||) — {'ok' if ok else 'FAIL'}")
    assert ok

    # check_matrices: every operator view must agree — matrix-free
    # formulations AND the assembled StencilMatrix, like the reference's
    # ||Ax - Px|| check against the assembled matrix (example.f90:235-261)
    from poissbox_tpu.ops.assemble import assemble_laplacian
    Ax = A(x_exact)
    views = {"pointwise": make_laplacian_operator(grid, impl="pointwise"),
             "roll": make_laplacian_operator(grid, impl="roll"),
             "assembled": assemble_laplacian(grid.n, grid.deltas, b.dtype)}
    ax_scale = float(jnp.linalg.norm(Ax.ravel()))
    for name, Ai in views.items():
        d = float(jnp.linalg.norm((Ax - Ai(x_exact)).ravel()))
        print(f"check_matrices[{name}]: ||A x - P x||_2 = {d:.3e} "
              f"(relative {d / ax_scale:.3e}, tol {tol:.1e}) — "
              f"{'ok' if d < tol * ax_scale + tol else 'FAIL'}")
        assert d < tol * ax_scale + tol, (name, d)

    # -- solve (reference example.f90:78-84) -------------------------------
    if not opts.has("ksp_type"):
        opts.set("ksp_type", "cg")     # solver of record (README.md:42-47)
    if not opts.has("pc_type"):
        opts.set("pc_type", "mg")
    sopts = SolverOptions.from_options(opts)
    t0 = time.perf_counter()
    # pass the options DB itself so DB-level flags (-log_view,
    # -options_left, ...) reach the KSP layer, as in PETSc
    res = solve(A, b, opts, grid=grid)
    jax.block_until_ready(res.x)
    dt = time.perf_counter() - t0

    true_res = float(jnp.linalg.norm((A(res.x) - b).ravel()))
    b_norm = float(jnp.linalg.norm(b.ravel()))
    err = float(jnp.linalg.norm((res.x - x_exact).ravel()))
    print(f"solve: {int(res.iterations)} iterations in {dt:.3f}s "
          f"({sopts.ksp_type}+{sopts.pc_type})")
    # -ksp_converged_reason analogue (reference README.md:48-49): surface a
    # stalled solve (e.g. rtol below f32 reach) instead of silently passing
    clamped_note = " (rtol clamped to f32 reach)" if rtol_clamped else ""
    print(f"converged reason: {res.reason_enum().message}{clamped_note}")
    print(f"verification: ||Ax - b||_2 = {true_res:.6e} "
          f"(relative {true_res / b_norm:.3e}), ||x - x_exact||_2 = {err:.3e}")

    # `-options_left` analogue (PETSc options-DB semantics): every flag the
    # run consumed was marked; anything left is a typo or a no-op — report
    # it, or raise under `-options_error_if_unused`
    if opts.get_bool("options_error_if_unused"):
        opts.check_unused(error=True)
    else:
        for k in opts.unused_keys():
            print(f"WARNING: option -{k} was set but never used")
    return DemoReport(true_res / b_norm, int(res.iterations), int(res.reason))


def main(argv=None) -> int:
    from poissbox_tpu.utils.compile_cache import setup_compile_cache

    opts = Options(sys.argv[1:] if argv is None else argv)
    setup_compile_cache()
    run(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
