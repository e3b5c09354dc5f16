#!/usr/bin/env python
"""Smoke test of poissbox_tpu's main path on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: the phases listed below
    python chip_smoke.py --multi   # four GPUs in one process: the sharded
                                   # MG-CG at 1024^3 and the pencil FFT at
                                   # 512^3, each against one card

Every phase drives a user entry point at a real size (PoissonSolver, the
demo, which solves through ksp.solve) and checks what comes out against a
plain reference that does not share the code under test. Each phase prints
one line: what ran; the first call's wall time (compile + run) and the warm
call's, both on the host clock around `block_until_ready`; iterations and
converged reason; the true relative residual computed in float64 with its
tolerance; the difference from the reference with its tolerance; the card.

Nothing is caught: a failed check raises, the process exits non-zero and
the final line is not printed. A JAX device other than a GPU is refused
before any work. The last line is exactly

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Tolerances and why (XLA on the GPU sums in another order than on the CPU,
so nothing below asks for bit equality):

  * solver convergence: reason > 0 and the true residual ||b - A x|| /
    ||b||, in float64, at most rtol * 1.01 (MG-CG: rtol 1e-6 in float32,
    the demo: 1e-8 in float64). CG stops on its recursive residual, which
    tracks the true one to a few per cent; 1% is the margin.
  * float32 FFT direct solve: true residual <= 1e-5. The transforms' own
    round-off is ~log2(N) * eps_f32 (~2e-6 at 512^3); 1e-5 leaves a 5x
    margin and still fails any wrong symbol or layout by orders.
  * second-order solutions against the manufactured x_exact and against a
    float64 rfftn pseudo-inverse of the same b: for any iterate x,
    x - A^+ b = -A^+ r (up to the constant mode), so
    ||x - x_ref|| <= ||r|| / lambda_min, with lambda_min the smallest
    non-zero |eigenvalue| of the periodic 7-point operator. For x_exact the
    float32 rounding d = b - A x_exact of the manufactured RHS adds
    ||d|| / lambda_min. Mean offsets (null space) are added explicitly.
    These bounds are exact inequalities, evaluated in float64.
  * 7-point stencil (float32) against the 27-point box form in float64:
    relative 2-norm <= 64 eps_f32 (each point sums 7 terms of magnitude
    ~|u|/h^2; the rounding is a few eps relative to ||A u||).
  * 6th-order compact operators (float64, analytic sin field): relative
    RMS <= 1e-9, the reference's tier for lapl/div at 64^3 (same k h as
    here), scaled by (64/n)^6 below 64^3, where the 6th-order truncation
    error is larger; at 512^3 the truncation (k h)^6 ~ 4e-12 and the
    float64 rounding, amplified by 1/h^2, ~2e-12 are both far below it.
    The spectral solve inverts the same operator, so its error is
    rounding only: 1e-9 at every n.
  * sharded against one card (--multi): both solutions satisfy their own
    residual bound, so ||x_s - x_1|| <= (||r_s|| + ||r_1||) / lambda_min;
    iteration counts may differ by one (reduction order).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Problem sizes of the phases (cubes).
SIZES = {"stencil": 512, "mgcg": (512, 1024), "fft": 512, "compact": 512,
         "demo": 256, "multi_mgcg": 1024, "multi_fft": 512}
MGCG_RTOL = 1e-6
DEMO_RTOL = 1e-8
FFT_F32_RTOL = 1e-5
STENCIL_EPS_FACTOR = 64
COMPACT_TOL = 1e-9
SEED = 2026


class SmokeFailure(AssertionError):
    pass


def check(ok, msg: str) -> None:
    if not bool(ok):
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# device and card
# ---------------------------------------------------------------------------

def require_platform(devices, platform: str = "gpu") -> None:
    """Refuse any device but `platform` (no fallback to another device)."""
    got = devices[0].platform
    if got != platform:
        raise SystemExit(f"chip_smoke: needs a {platform} device; "
                         f"JAX found {got} ({devices[0].device_kind})")


def card_lines() -> list[str]:
    """The cards' name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


# ---------------------------------------------------------------------------
# plain float64 references (independent of the code under test)
# ---------------------------------------------------------------------------

def lapl7_f64(x, deltas):
    """Periodic 7-point Laplacian in float64, written out here."""
    x = x.astype(jnp.float64)
    out = jnp.zeros_like(x)
    for ax, d in enumerate(deltas):
        out = out + (jnp.roll(x, 1, ax) - 2.0 * x + jnp.roll(x, -1, ax)) / d**2
    return out


def pinv_fft_f64(b, deltas):
    """float64 pseudo-inverse of the periodic 7-point Laplacian through
    jnp.fft.rfftn (eigenvalues -4 sin^2(pi k / n) / h^2, zero mode
    dropped)."""
    b = b.astype(jnp.float64)
    n = b.shape

    def lam(ax, m):
        k = jnp.arange(m, dtype=jnp.float64)
        return -4.0 * jnp.sin(np.pi * k / n[ax]) ** 2 / deltas[ax] ** 2

    eig = (lam(0, n[0])[:, None, None] + lam(1, n[1])[None, :, None]
           + lam(2, n[2] // 2 + 1)[None, None, :])
    inv = jnp.where(eig == 0.0, 0.0, 1.0 / jnp.where(eig == 0.0, 1.0, eig))
    return jnp.fft.irfftn(jnp.fft.rfftn(b) * inv, s=n)


def lambda_min(shape, deltas) -> float:
    """Smallest non-zero |eigenvalue| of the periodic 7-point operator."""
    return min(4.0 * np.sin(np.pi / m) ** 2 / d**2
               for m, d in zip(shape, deltas))


def _norm(v):
    return jnp.sqrt(jnp.sum(jnp.square(v.astype(jnp.float64))))


def solution_checks(x, b, x_exact, deltas) -> dict:
    """True residual and distances to x_exact and to the float64 FFT
    pseudo-inverse of b, each with its bound (module docstring)."""

    @jax.jit
    def scalars(x, b, xe):
        x64, b64, xe64 = (v.astype(jnp.float64) for v in (x, b, xe))
        return {
            "bnorm": _norm(b64),
            "rnorm": _norm(b64 - lapl7_f64(x64, deltas)),
            "dnorm": _norm(b64 - lapl7_f64(xe64, deltas)),
            "mean_x": jnp.mean(x64), "mean_e": jnp.mean(xe64),
            "xnorm": _norm(xe64),
            "err_exact": _norm(x64 - xe64),
            "err_fft": _norm(x64 - pinv_fft_f64(b64, deltas)),
        }

    s = {k: float(v) for k, v in scalars(x, b, x_exact).items()}
    lmin = lambda_min(x.shape, deltas)
    root_n = float(np.sqrt(x.size))
    slack = 1e-10 * s["xnorm"]          # float64 evaluation of the norms
    s["rel_res"] = s["rnorm"] / s["bnorm"]
    s["tol_exact"] = ((s["rnorm"] + s["dnorm"]) / lmin
                      + root_n * (abs(s["mean_x"]) + abs(s["mean_e"])) + slack)
    s["tol_fft"] = s["rnorm"] / lmin + root_n * abs(s["mean_x"]) + slack
    return s


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def timed(fn, *args):
    """(result, first-call seconds, warm-call seconds)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def _peak_gb(device) -> str:
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 1e9:.2f} GB"


def _fmt(name, what, first, warm, body, card) -> str:
    return (f"phase {name}: {what} | first call (compile+run) {first:.3f} s,"
            f" warm {warm:.6f} s | {body} | card: {card}")


def phase_stencil(n: int, card: str) -> str:
    from poissbox_tpu.mesh import Grid3D
    from poissbox_tpu.ops.stencil import (
        apply_laplacian_pointwise,
        make_laplacian_operator,
    )

    grid = Grid3D((n, n, n))
    A = make_laplacian_operator(grid)
    u = grid.random(jax.random.PRNGKey(SEED), jnp.float32)
    au, first, warm = timed(jax.jit(A.apply), u)
    check(au.shape == u.shape and au.dtype == jnp.float32,
          f"stencil output {au.shape} {au.dtype}")
    ref = jax.jit(lambda v: apply_laplacian_pointwise(
        v.astype(jnp.float64), grid.deltas))(u)
    rel = float(_norm(au.astype(jnp.float64) - ref) / _norm(ref))
    tol = STENCIL_EPS_FACTOR * float(jnp.finfo(jnp.float32).eps)
    check(np.isfinite(rel) and rel <= tol,
          f"stencil {n}^3: ||A u - box64 u|| / ||box64 u|| = {rel:.3e} > {tol:.1e}")
    return _fmt(f"stencil_{n}", f"7-point operator (roll), f32 {n}^3",
                first, warm,
                f"vs 27-point box form in f64: rel 2-norm {rel:.3e} <= {tol:.1e}",
                card)


def _second_order_line(s, rtol) -> str:
    return (f"true rel residual (f64) {s['rel_res']:.3e} <= {rtol * 1.01:.3e} |"
            f" ||x - x_exact|| {s['err_exact']:.3e} <= {s['tol_exact']:.3e}"
            f" (rel {s['err_exact'] / s['xnorm']:.2e}),"
            f" ||x - fft64(b)|| {s['err_fft']:.3e} <= {s['tol_fft']:.3e}")


def _check_second_order(s, rtol, what) -> None:
    check(np.isfinite(s["rel_res"]) and s["rel_res"] <= rtol * 1.01,
          f"{what}: true relative residual {s['rel_res']:.3e} > {rtol * 1.01:.3e}")
    check(s["err_exact"] <= s["tol_exact"],
          f"{what}: ||x - x_exact|| {s['err_exact']:.3e} > {s['tol_exact']:.3e}")
    check(s["err_fft"] <= s["tol_fft"],
          f"{what}: ||x - fft64(b)|| {s['err_fft']:.3e} > {s['tol_fft']:.3e}")


def phase_mgcg(n: int, card: str) -> str:
    from poissbox_tpu.api import PoissonSolver
    from poissbox_tpu.config import SolverOptions

    opts = SolverOptions(ksp_type="cg", pc_type="mg", ksp_rtol=MGCG_RTOL,
                         ksp_max_it=100)
    solver = PoissonSolver((n, n, n), options=opts, dtype=jnp.float32)
    x_exact = solver.random_solution(SEED)
    b = solver.rhs_for(x_exact)
    res, first, warm = timed(solver.solve, b)
    its, reason = int(res.iterations), int(res.reason)
    check(res.x.shape == (n, n, n) and res.x.dtype == jnp.float32,
          f"MG-CG output {res.x.shape} {res.x.dtype}")
    check(reason > 0, f"MG-CG {n}^3 did not converge: reason {reason}")
    peak = _peak_gb(jax.devices()[0])
    s = solution_checks(res.x, b, x_exact, solver.grid.deltas)
    _check_second_order(s, MGCG_RTOL, f"MG-CG {n}^3")
    cfg = solver._solver.M.config
    return _fmt(f"mgcg_{n}",
                f"PoissonSolver CG + MG V({cfg.pre_smooth},{cfg.post_smooth})"
                f" f32 {n}^3 rtol {MGCG_RTOL:g}, peak device memory {peak}",
                first, warm,
                f"iterations {its}, reason {reason} | "
                + _second_order_line(s, MGCG_RTOL), card)


def phase_fft(n: int, card: str) -> str:
    from poissbox_tpu.api import PoissonSolver
    from poissbox_tpu.config import SolverOptions

    solver = PoissonSolver((n, n, n), options=SolverOptions(ksp_type="fft"),
                           dtype=jnp.float32)
    x_exact = solver.random_solution(SEED)
    b = solver.rhs_for(x_exact)
    res, first, warm = timed(solver.solve, b)
    reason = int(res.reason)
    check(reason > 0, f"FFT solve reason {reason}")
    s = solution_checks(res.x, b, x_exact, solver.grid.deltas)
    _check_second_order(s, FFT_F32_RTOL, f"FFT {n}^3")
    return _fmt(f"fft_{n}", f"PoissonSolver -ksp_type fft (rfftn) f32 {n}^3",
                first, warm,
                f"iterations {int(res.iterations)}, reason {reason} | "
                + _second_order_line(s, FFT_F32_RTOL), card)


def phase_compact(n: int, card: str) -> str:
    from poissbox_tpu.api import PoissonSolver
    from poissbox_tpu.config import SolverOptions

    solver = PoissonSolver((n, n, n), options=SolverOptions(ksp_type="fft"),
                           dtype=jnp.float64, order=6)
    g = solver.grid
    xs = [g.cells(d).astype(jnp.float64) for d in range(3)]
    k = 2.0 * np.pi
    u = (jnp.sin(k * xs[0])[:, None, None] + jnp.sin(k * xs[1])[None, :, None]
         + jnp.sin(k * xs[2])[None, None, :])
    exact = -k * k * u
    lapl, first, warm = timed(jax.jit(solver.A.apply), u)

    def rel_rms(a, ref):
        return float(jnp.sqrt(jnp.mean(jnp.square(a - ref))
                              / jnp.mean(jnp.square(ref))))

    e_lapl = rel_rms(lapl, exact)
    tol_lapl = COMPACT_TOL * max(1.0, (64.0 / n) ** 6)
    check(e_lapl <= tol_lapl,
          f"compact lapl {n}^3: rel RMS vs analytic {e_lapl:.3e} > {tol_lapl:g}")
    res, s_first, s_warm = timed(solver.solve, lapl)
    reason = int(res.reason)
    check(reason > 0, f"compact spectral solve reason {reason}")
    e_sol = rel_rms(res.x, u)
    rel_res = float(_norm(jax.jit(solver.A.apply)(res.x) - lapl) / _norm(lapl))
    check(e_sol <= COMPACT_TOL and rel_res <= COMPACT_TOL,
          f"compact solve {n}^3: rel RMS error {e_sol:.3e}, residual "
          f"{rel_res:.3e} > {COMPACT_TOL:g}")
    return _fmt(f"compact6_{n}",
                f"6th-order compact lapl + PoissonSolver(order=6) fft solve,"
                f" f64 {n}^3 (solve: first {s_first:.3f} s, warm {s_warm:.6f} s)",
                first, warm,
                f"iterations {int(res.iterations)}, reason {reason} | true rel"
                f" residual (f64) {rel_res:.3e} <= {COMPACT_TOL:g} | vs analytic"
                f" sin field: lapl rel RMS {e_lapl:.3e} <= {tol_lapl:.1e},"
                f" solution rel RMS"
                f" {e_sol:.3e} <= {COMPACT_TOL:g}", card)


def phase_demo(n: int, card: str) -> str:
    from poissbox_tpu.config import Options
    from poissbox_tpu.demo import run

    argv = ["-n", str(n), "-ksp_rtol", str(DEMO_RTOL)]
    t0 = time.perf_counter()
    rep = run(Options(argv))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep2 = run(Options(argv))
    second = time.perf_counter() - t0
    for r in (rep, rep2):
        check(r.reason > 0, f"demo {n}^3 did not converge: reason {r.reason}")
        check(np.isfinite(r.rel_residual)
              and r.rel_residual <= DEMO_RTOL * 1.01,
              f"demo {n}^3: true relative residual {r.rel_residual:.3e}")
    return _fmt(f"demo_{n}",
                f"python -m poissbox_tpu.demo -n {n} -ksp_rtol {DEMO_RTOL:g}"
                f" (f64, CG + MG; check_lapl and check_matrices passed;"
                f" 'warm' is a second full run: ksp.solve jits per call)",
                first, second,
                f"iterations {rep.iterations}, reason {rep.reason} | true rel"
                f" residual (f64) {rep.rel_residual:.3e} <= {DEMO_RTOL * 1.01:.3e}",
                card)


def _check_shards(x, devices, grid) -> None:
    shards = x.addressable_shards
    got = {s.device for s in shards}
    check(got == set(devices) and len(shards) == len(devices),
          f"result shards on {sorted(str(d) for d in got)}, expected "
          f"{sorted(str(d) for d in devices)}")
    want = tuple(n // p for n, p in zip(grid.n, grid.pgrid))
    for s in shards:
        check(tuple(s.data.shape) == want,
              f"shard on {s.device} has shape {s.data.shape}, expected {want}")


def phase_multi(n_mg: int, n_fft: int, card: str) -> list[str]:
    """Sharded MG-CG (PoissonSolver(shard=True): the mesh decompose_3d
    picks over all local devices) and the pencil FFT solve, each against
    the same right-hand side solved on the first device alone."""
    from poissbox_tpu.api import PoissonSolver
    from poissbox_tpu.config import SolverOptions
    from poissbox_tpu.mesh import Grid3D
    from poissbox_tpu.ops.stencil import make_laplacian_operator
    from poissbox_tpu.solvers.fft import poisson_solve_fft, poisson_solve_fft_dist

    devs = jax.devices()
    d0 = devs[0]
    lines = []

    opts = SolverOptions(ksp_type="cg", pc_type="mg", ksp_rtol=MGCG_RTOL,
                         ksp_max_it=100)
    solver_s = PoissonSolver((n_mg,) * 3, options=opts, shard=True,
                             dtype=jnp.float32)
    g = solver_s.grid
    x_exact = solver_s.random_solution(SEED)
    b = solver_s.rhs_for(x_exact)
    res_s, first_s, warm_s = timed(solver_s.solve, b)
    _check_shards(res_s.x, devs, g)
    solver_1 = PoissonSolver((n_mg,) * 3, options=opts, dtype=jnp.float32)
    b1 = jax.device_put(b, d0)
    res_1, first_1, warm_1 = timed(solver_1.solve, b1)
    check(res_1.x.devices() == {d0}, f"single-card result on {res_1.x.devices()}")
    its_s, its_1 = int(res_s.iterations), int(res_1.iterations)
    check(int(res_s.reason) > 0 and int(res_1.reason) > 0,
          f"reasons sharded {int(res_s.reason)}, one card {int(res_1.reason)}")
    check(abs(its_s - its_1) <= 1, f"iterations sharded {its_s} vs {its_1}")
    xs = jax.device_put(res_s.x, d0)
    s_s = solution_checks(xs, b1, jax.device_put(x_exact, d0), g.deltas)
    s_1 = solution_checks(res_1.x, b1, jax.device_put(x_exact, d0), g.deltas)
    _check_second_order(s_s, MGCG_RTOL, f"sharded MG-CG {n_mg}^3")
    _check_second_order(s_1, MGCG_RTOL, f"one-card MG-CG {n_mg}^3")
    diff = float(_norm(xs.astype(jnp.float64) - res_1.x.astype(jnp.float64)))
    lmin = lambda_min(g.n, g.deltas)
    tol = (s_s["rnorm"] + s_1["rnorm"]) / lmin + 1e-10 * s_1["xnorm"]
    check(diff <= tol, f"sharded vs one card: {diff:.3e} > {tol:.3e}")
    lines.append(_fmt(
        f"multi_mgcg_{n_mg}",
        f"PoissonSolver(shard=True) CG + MG f32 {n_mg}^3 on pgrid {g.pgrid}"
        f" over {len(devs)} devices (shards checked per device); one card:"
        f" first {first_1:.3f} s, warm {warm_1:.6f} s, {its_1} iterations",
        first_s, warm_s,
        f"iterations {its_s}, reason {int(res_s.reason)} | true rel residual"
        f" (f64) sharded {s_s['rel_res']:.3e}, one card {s_1['rel_res']:.3e}"
        f" <= {MGCG_RTOL * 1.01:.3e} | ||x_sharded - x_one_card||"
        f" {diff:.3e} <= {tol:.3e} (rel {diff / s_1['xnorm']:.2e})", card))
    del res_s, res_1, xs, b, b1, x_exact

    # pencil FFT against the single-card FFT
    gf = Grid3D((n_fft,) * 3).with_mesh(devices=devs)
    A = make_laplacian_operator(gf)
    xe = A.project(gf.random(jax.random.PRNGKey(SEED), jnp.float32))
    bf = jax.jit(A.apply)(xe)
    xd, first_d, warm_d = timed(jax.jit(lambda v: poisson_solve_fft_dist(v, gf)),
                                bf)
    _check_shards(xd, devs, gf)
    bf1 = jax.device_put(bf, d0)
    x1, first_f1, warm_f1 = timed(
        jax.jit(lambda v: poisson_solve_fft(v, gf.deltas)), bf1)
    xd0 = jax.device_put(xd, d0)
    xe0 = jax.device_put(xe, d0)
    f_d = solution_checks(xd0, bf1, xe0, gf.deltas)
    f_1 = solution_checks(x1, bf1, xe0, gf.deltas)
    _check_second_order(f_d, FFT_F32_RTOL, f"pencil FFT {n_fft}^3")
    _check_second_order(f_1, FFT_F32_RTOL, f"one-card FFT {n_fft}^3")
    diff = float(_norm(xd0.astype(jnp.float64) - x1.astype(jnp.float64)))
    tol = ((f_d["rnorm"] + f_1["rnorm"]) / lambda_min(gf.n, gf.deltas)
           + 1e-10 * f_1["xnorm"])
    check(diff <= tol, f"pencil FFT vs one card: {diff:.3e} > {tol:.3e}")
    lines.append(_fmt(
        f"multi_fft_{n_fft}",
        f"poisson_solve_fft_dist f32 {n_fft}^3 on pgrid {gf.pgrid} over"
        f" {len(devs)} devices (shards checked per device); one card: first"
        f" {first_f1:.3f} s, warm {warm_f1:.6f} s",
        first_d, warm_d,
        f"true rel residual (f64) pencil {f_d['rel_res']:.3e}, one card"
        f" {f_1['rel_res']:.3e} <= {FFT_F32_RTOL:g} | ||x_pencil - x_one_card||"
        f" {diff:.3e} <= {tol:.3e} (rel {diff / f_1['xnorm']:.2e})", card))
    return lines


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

MULTI_DEVICES = 4


def main(argv=None, *, platform: str = "gpu", sizes=None, cards=None) -> int:
    """Run the phases; `platform`, `sizes` and `cards` are for the CPU tests
    (the platform check stays on, with the platform they inject)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help=f"{MULTI_DEVICES} GPUs in one process: sharded "
                         "MG-CG and pencil FFT against one card (only)")
    args = ap.parse_args(argv)
    sizes = dict(SIZES if sizes is None else sizes)

    jax.config.update("jax_enable_x64", True)   # float64 references
    devices = jax.devices()
    require_platform(devices, platform)
    if args.multi:
        check(len(devices) == MULTI_DEVICES,
              f"--multi needs {MULTI_DEVICES} devices, JAX has {len(devices)}")
    from poissbox_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    cards = card_lines() if cards is None else cards
    card = "; ".join(cards)
    print(f"chip_smoke: {len(devices)} x {devices[0].device_kind}, jax "
          f"{jax.__version__}, card(s): {card}", flush=True)

    if args.multi:
        lines = phase_multi(sizes["multi_mgcg"], sizes["multi_fft"], card)
    else:
        lines = [phase_stencil(sizes["stencil"], card)]
        for n in sizes["mgcg"]:
            lines.append(phase_mgcg(n, card))
        lines.append(phase_fft(sizes["fft"], card))
        lines.append(phase_compact(sizes["compact"], card))
        lines.append(phase_demo(sizes["demo"], card))
    for ln in lines:
        print(ln, flush=True)
    for ln in cards:
        print(ln)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
