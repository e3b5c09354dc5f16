"""Matrix-free 7-point Laplacian stencil operators.

The replacement for the reference's matrix-free operator stack:
MatShell + MATOP_MULT callback + `compute_lapl_pointwise`'s halo exchange
and triple loop (reference src/poissbox.f90:24-150). Two equivalent
formulations, cross-checked by tests exactly as the reference demo
cross-checks matvec vs pointwise application (reference src/example.f90:201-233):

  * :func:`apply_laplacian` — shifted-adds on the global (possibly sharded)
    array. Under `jit` + GSPMD, XLA partitions the rolls into
    collective-permute halo exchanges and fuses the elementwise tree into a
    single memory-bound pass; this is the production path.
  * :func:`apply_laplacian_pointwise` — an independent formulation via the
    full 3x3x3 coefficient box (dot with `lapl_star_coeffs`), mirroring
    `evaluate_laplacian_pointwise` (reference src/poissbox.f90:128-148).

Multi-device meshes run the correction-form shard_map operator of
:mod:`poissbox_tpu.parallel.dist_stencil` around the roll formulation.

All are periodic; fields are cell-centered on a uniform grid.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from poissbox_tpu.ops.coefficients import lapl_star_coeffs


def apply_laplacian(u: jax.Array, deltas: Sequence[float]) -> jax.Array:
    """Periodic 2nd-order Laplacian of a 3-D field via shifted adds.

    Evaluates per axis as (f_{+1} + f_{-1}) * invdx2 and subtracts the
    accumulated center term — the grouping the reference's tests note is the
    more accurate evaluation order (reference tests/coefficients/
    test_d2dx2.f90:185-190).
    """
    if u.ndim != len(deltas):
        raise ValueError(f"field rank {u.ndim} != len(deltas) {len(deltas)}")
    acc = jnp.zeros_like(u)
    center = 0.0
    for ax, dd in enumerate(deltas):
        inv = 1.0 / float(dd) ** 2
        acc = acc + (jnp.roll(u, 1, ax) + jnp.roll(u, -1, ax)) * inv
        center += 2.0 * inv
    return acc - center * u


def apply_laplacian_pointwise(u: jax.Array, deltas: Sequence[float]) -> jax.Array:
    """Independent evaluation through the full 3x3x3 star box.

    Gathers every (di, dj, dk) in [-1, 0, 1]^3 neighborhood by periodic roll
    and contracts with `lapl_star_coeffs` — the array form of the
    reference's per-point 27-wide dot (reference src/poissbox.f90:112-148),
    vectorized over the whole grid instead of looping.
    """
    dx, dy, dz = deltas
    box = lapl_star_coeffs(dx, dy, dz, dtype=u.dtype)
    out = jnp.zeros_like(u)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                c = box[di + 1, dj + 1, dk + 1]
                # rolling by -d brings u[i+d] to position i
                shifted = jnp.roll(u, (-di, -dj, -dk), axis=(0, 1, 2))
                out = out + c * shifted
    return out


def default_impl(mesh=None) -> str:
    """Pick the stencil implementation: 'dist' (shard_map + ppermute halo
    corrections around the roll bulk pass) on a multi-device mesh, the XLA
    roll formulation otherwise."""
    return "dist" if mesh is not None and mesh.size > 1 else "roll"


def make_laplacian_operator(grid, impl: str = "auto"):
    """Build the matrix-free Laplacian LinearOperator for a Grid3D.

    The assembled-P / matrix-free-A pair of the reference collapses to one
    operator object exposing apply + diagonal + nullspace — what KSP and the
    MG preconditioner actually consume (reference src/poissbox.f90:206-267).
    `impl`: 'roll' (GSPMD shifted-adds), 'pointwise' (3x3x3 box
    contraction), or 'dist' (shard_map + ppermute halo corrections — the
    multi-device path, parallel.dist_stencil).
    """
    from poissbox_tpu.linops import LinearOperator, make_nullspace_projector

    deltas = grid.deltas
    if impl == "auto":
        impl = default_impl(grid.mesh)
    if impl == "dist" and getattr(grid, "uneven", False):
        impl = "uneven"  # non-divisible decomposition: padded layout
    apply_dot = None
    nullspace = make_nullspace_projector()
    if impl == "roll":
        apply = lambda u: apply_laplacian(u, deltas)
    elif impl == "pointwise":
        apply = lambda u: apply_laplacian_pointwise(u, deltas)
    elif impl == "uneven":
        # pad-and-mask execution for decompositions that do not divide the
        # grid (PETSc DMDA parity: 64^3 on 3 ranks, reference
        # README.md:25-33); explicit masked projector — the folded
        # rank-one projection in the solvers assumes the even layout
        from poissbox_tpu.parallel.uneven import (
            apply_laplacian_uneven,
            make_masked_projector,
        )
        apply = lambda u: apply_laplacian_uneven(u, grid)
        nullspace = make_masked_projector(grid)
    elif impl == "dist":
        if grid.mesh is None:
            raise ValueError("impl='dist' needs a grid with a device mesh")
        from poissbox_tpu.parallel.dist_stencil import (
            apply_laplacian_dot_sharded,
            apply_laplacian_sharded,
        )
        apply = lambda u: apply_laplacian_sharded(u, grid)
        apply_dot = lambda u: apply_laplacian_dot_sharded(u, grid)
    else:
        raise ValueError(f"unknown stencil impl {impl!r} "
                         "(expected auto|roll|pointwise|dist)")

    diag_val = -2.0 * sum(1.0 / float(d) ** 2 for d in deltas)

    def direct_solve(b):
        from poissbox_tpu.solvers.fft import poisson_solve_fft
        return poisson_solve_fft(b, deltas)

    return LinearOperator(
        apply=apply,
        diagonal=lambda: jnp.asarray(diag_val),
        nullspace=nullspace,
        symmetric=True,
        apply_dot=apply_dot,
        direct_solve=None if grid.mesh is not None and grid.mesh.size > 1
        else direct_solve,
    )


def laplacian_local(u_padded: jax.Array, deltas: Sequence[float]) -> jax.Array:
    """Apply the 7-point star to a halo-padded local block (width-1 halos).

    Input has shape (nx+2, ny+2, nz+2); output (nx, ny, nz). Used by the
    explicit shard_map path where halos were filled by
    `parallel.halo.halo_pad_local`.
    """
    invs = [1.0 / float(d) ** 2 for d in deltas]
    c = u_padded[1:-1, 1:-1, 1:-1]
    out = (u_padded[2:, 1:-1, 1:-1] + u_padded[:-2, 1:-1, 1:-1]) * invs[0]
    out = out + (u_padded[1:-1, 2:, 1:-1] + u_padded[1:-1, :-2, 1:-1]) * invs[1]
    out = out + (u_padded[1:-1, 1:-1, 2:] + u_padded[1:-1, 1:-1, :-2]) * invs[2]
    return out - (2.0 * sum(invs)) * c
