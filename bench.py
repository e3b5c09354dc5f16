"""Bring-up benchmark on one NVIDIA GPU — prints ONE JSON line.

Times the XLA paths of the solver's hot layers at one grid size (default
512^3, float32) against a large-copy bandwidth measured in the same
process, plus two A/B pairs of the multigrid defaults:

  * copy ............ y = s * x over a 2 GiB float32 array
  * apply ........... one 7-point Laplacian apply (roll form)
  * sor_sweep ....... one red-black SOR sweep (both colours)
  * mgcg_iteration .. one MG-preconditioned CG iteration (from two fixed
                      iteration counts)
  * mgcg_solve ...... the MG-CG solve to rtol (PoissonSolver)
  * compact_pcr / compact_pscan  the 6th-order compact Laplacian with each
                      line solve
  * fft_solve ....... the FFT direct solve (rfftn / irfftn)
  * f64 row ......... MG-CG at --f64-n in float64 (x64 restored after)
  * A/B ............. V(1,1) vs V(2,2), and bf16 pre-smooth on vs off, for
                      the MG-CG solve

Each time is the best of several timings on the host clock around
`block_until_ready` (utils.profiling.kernel_time); sub-millisecond
operations enqueue `k` calls and block once. For each operation `passes` = time * copy bandwidth / (bytes of one
field): the number of full field reads or writes the time would buy at the
measured copy rate. `model_passes` is what the operation must move at
least (each named stage reads its inputs and writes its output once), and
`copy_share` = model_passes / passes. The published peak of the card
(HBM_GBPS, keyed by device_kind) is reported beside the copy rate; a
device that is not in the table is an error, and so is any platform but
a GPU.

Usage: python bench.py [--n 512] [--f64-n 128]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import jax
import jax.numpy as jnp

from poissbox_tpu.utils.profiling import kernel_time

# Published device-memory bandwidth, GB/s (decimal), by device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, H100 SXM: 3.35 TB/s.
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def hbm_gbps(kind: str) -> float:
    """Published bandwidth of `kind`; an unknown device is an error."""
    if kind not in HBM_GBPS:
        raise KeyError(f"no published bandwidth for device kind {kind!r}; "
                       f"known: {sorted(HBM_GBPS)}")
    return HBM_GBPS[kind]


def require_gpu(devices) -> None:
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{devices[0].platform} ({devices[0].device_kind})")


def copy_gbps() -> float:
    """Large-copy rate: read 2 GiB, write 2 GiB (scale by a traced scalar,
    so XLA cannot elide the pass)."""
    x = jnp.ones((512 * 2**20,), jnp.float32)
    s = jnp.float32(1.0000001)
    t = kernel_time(lambda v, c: v * c, x, s, k=10)
    return 2 * x.size * 4 / t / 1e9


def _entry(t: float, model_passes: float, field_bytes: int,
           bw_gbps: float, **extra) -> dict:
    passes = t * bw_gbps * 1e9 / field_bytes
    return {"ms": t * 1e3, "passes": passes, "model_passes": model_passes,
            "copy_share": model_passes / passes, **extra}


def bench_layers(n: int, bw: float) -> dict:
    from poissbox_tpu.api import PoissonSolver
    from poissbox_tpu.config import SolverOptions
    from poissbox_tpu.mesh import Grid3D
    from poissbox_tpu.ops import compact
    from poissbox_tpu.ops.stencil import make_laplacian_operator
    from poissbox_tpu.solvers import mg
    from poissbox_tpu.solvers.cg import cg
    from poissbox_tpu.solvers.fft import poisson_solve_fft

    f32 = jnp.float32
    grid = Grid3D((n, n, n))
    fb = grid.ndof * 4
    A = make_laplacian_operator(grid)
    key = jax.random.PRNGKey(0)
    x = A.project(grid.random(key, f32))
    b = jax.jit(A.apply)(x)
    out = {}

    out["apply"] = _entry(kernel_time(A.apply, x, k=20), 2, fb, bw)

    lvl = mg._Level(grid.n, grid.deltas, -2.0 * sum(1 / d**2 for d in grid.deltas))
    sweep = lambda u, f: mg._smooth(u, f, lvl, mg.MGConfig(), 1,
                                    reverse=False)
    # a fused sweep reads x and b and writes x
    out["sor_sweep"] = _entry(kernel_time(sweep, x, b, k=20), 3, fb, bw)

    M = mg.make_mg_preconditioner(grid.n, grid.deltas, mg.MGConfig(), dtype=f32)
    its = {}
    for k in (4, 12):
        solve_k = lambda r, k=k: cg(A, r, M=M, rtol=0.0, max_it=k).x
        its[k] = kernel_time(solve_k, b)
    t_it = (its[12] - its[4]) / 8
    # CG algebra (matvec 2, x 3, r 3, dots 2, p 3) + fine V(1,1) level
    # (bf16 pre-smooth 1.5, residual 3, restrict 1.125, prolong-add 2.125,
    # post-smooth 3) + coarse levels (1/7 of the fine level's 10.75)
    model_it = 13 + 10.75 * 8 / 7
    out["mgcg_iteration"] = _entry(t_it, model_it, fb, bw)

    opts = SolverOptions(ksp_type="cg", pc_type="mg", ksp_rtol=1e-6,
                         ksp_max_it=100)
    solver = PoissonSolver(grid.n, options=opts, dtype=f32)
    res = solver.solve(b)
    n_it = int(res.iterations)
    out["mgcg_solve"] = _entry(
        kernel_time(solver.solve, b), n_it * model_it, fb, bw, iterations=n_it,
        rel_residual=float(res.residual_norm / res.history[0]),
        cycle=f"V({M.config.pre_smooth},{M.config.post_smooth})"
              f" pre {M.config.pre_dtype or 'f32'}")
    # A/B of the multigrid defaults at this size (default: see mgcg_solve)
    for name, cfg in (("ab_V22", mg.MGConfig(pre_smooth=2, post_smooth=2)),
                      ("ab_f32_pre", mg.MGConfig(pre_dtype="float32"))):
        Mc = mg.make_mg_preconditioner(grid.n, grid.deltas, cfg, dtype=f32)
        solve = jax.jit(lambda r, Mc=Mc: cg(A, r, M=Mc, rtol=1e-6, max_it=100))
        res = solve(b)
        out[name] = {"ms": kernel_time(solve, b) * 1e3,
                     "iterations": int(res.iterations),
                     "rel_residual": float(res.residual_norm / res.history[0]),
                     "cycle": f"V({Mc.config.pre_smooth},{Mc.config.post_smooth})"
                              f" pre {Mc.config.pre_dtype or 'f32'}"}

    d = grid.deltas
    for method in ("pcr", "pscan"):
        lap = lambda u, m=method: compact.lapl(u, d, method=m)
        # 18 line operators, each reading its input and writing its output
        # once, plus the gradient stack and the divergence sums
        out[f"compact_{method}"] = _entry(kernel_time(lap, x, k=3), 18 * 2 + 14,
                                          fb, bw)

    fft = lambda r: poisson_solve_fft(r, d)
    # rfftn: z pass read 1 / write 1 (half-size complex = 1 field), y and x
    # passes 2 each; multiply 2; irfftn the same 6
    out["fft_solve"] = _entry(kernel_time(fft, b, k=5), 14, fb, bw)
    return out


def bench_f64(n: int) -> dict:
    """MG-CG in float64 (the reference's precision of record) at n^3; x64
    mode is restored afterwards."""
    from poissbox_tpu.api import PoissonSolver
    from poissbox_tpu.config import SolverOptions

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        solver = PoissonSolver((n, n, n), options=SolverOptions(
            ksp_type="cg", pc_type="mg", ksp_rtol=1e-10, ksp_max_it=100),
            dtype=jnp.float64)
        b = solver.rhs_for(solver.random_solution(1))
        res = solver.solve(b)
        return {"n": n, "ms": kernel_time(solver.solve, b) * 1e3,
                "iterations": int(res.iterations),
                "rel_residual": float(res.residual_norm / res.history[0])}
    finally:
        jax.config.update("jax_enable_x64", prev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--f64-n", type=int, default=128)
    args = ap.parse_args(argv)
    devices = jax.devices()
    require_gpu(devices)
    from poissbox_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    kind = devices[0].device_kind
    peak = hbm_gbps(kind)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    bw = copy_gbps()
    record = {"device": {"platform": devices[0].platform, "kind": kind,
                         "count": len(devices)},
              "card": card, "n": args.n, "dtype": "float32",
              "copy_gbps": bw, "published_gbps": peak,
              "copy_share_of_published": bw / peak}
    print(f"bench: {record}", file=sys.stderr, flush=True)
    record["layers"] = bench_layers(args.n, bw)
    record["f64"] = bench_f64(args.f64_n)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
