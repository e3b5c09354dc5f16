"""Distributed compact-scheme operators — pencil-transposed sweeps.

Same numerics as :mod:`poissbox_tpu.ops.compact` (6th-order staggered
periodic schemes, reference src/compact_schemes.f90), with each directional
sweep executed in the pencil layout that makes its tridiagonal lines
device-local (parallel.pencil — the 2decomp transpose method, this
framework's sequence-parallel path). Sweep orders follow the reference
(`grad` Z->Y->X, src/compact_schemes.f90:42-88; `div` X->Y->Z, :207-257),
which is exactly one pencil transpose per sweep; outputs are restored to
the grid's home sharding.

On an unsharded grid every transpose is the identity and these functions
reduce to the serial operators (tests assert bit-equality of the two paths
on a multi-device mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from poissbox_tpu.ops import compact
from poissbox_tpu.parallel.pencil import from_pencil, pencil_spec, to_pencil

Array = jax.Array


def _uneven_fallback(fn_serial, f: Array, grid, vector_out: bool = False):
    """Non-divisible decomposition fallback: the pencil transposes need
    divisible shards, so gather the valid cells (parallel.uneven padded
    layout), apply the serial operator replicated, scatter back. The
    Krylov/MG paths stay distributed on uneven grids; the compact stack
    trades efficiency for capability there (the reference's compact stack
    is serial-only anyway, SURVEY.md §1)."""
    from poissbox_tpu.parallel.uneven import from_padded, to_padded

    if f.ndim == 4:  # vector field: gather per component
        fin = jnp.stack([from_padded(f[..., i], grid) for i in range(3)], -1)
    else:
        fin = from_padded(f, grid)
    out = fn_serial(fin)
    if vector_out:
        return jnp.stack([
            jax.lax.with_sharding_constraint(to_padded(out[..., i], grid),
                                             grid.sharding)
            for i in range(out.shape[-1])], axis=-1)
    return jax.lax.with_sharding_constraint(to_padded(out, grid),
                                            grid.sharding)


def _local_1d(fn, grid, local_dim: int):
    """Run a line operator on each device's pencil block via shard_map.

    After `to_pencil` the solve axis is unsharded, so the operator —
    periodic RHS rolls plus the line solve — is purely local to each
    shard; shard_map makes that explicit, which avoids any GSPMD
    re-gather.
    """
    if grid.mesh is None:
        return fn
    spec = pencil_spec(grid, local_dim)
    return jax.shard_map(fn, mesh=grid.mesh, in_specs=spec, out_specs=spec)


def grad(f: Array, grid) -> Array:
    """Distributed staggered gradient tensor (nx, ny, nz, 3) of a
    cell-centered sharded field."""
    if getattr(grid, "uneven", False):
        return _uneven_fallback(
            lambda v: compact.grad(v, grid.deltas), f, grid, vector_out=True)
    dx, dy, dz = grid.deltas
    # Z sweep (Z-pencils)
    fz = to_pencil(f, grid, 2, from_dim=None)
    fz_i = _local_1d(lambda v: compact.interp_1d(v, axis=2), grid, 2)(fz)
    fz_d = _local_1d(lambda v: compact.grad_1d(v, dz, axis=2), grid, 2)(fz)
    # Y sweep (Y-pencils)
    fz_i = to_pencil(fz_i, grid, 1, from_dim=2)
    fz_d = to_pencil(fz_d, grid, 1, from_dim=2)
    c1 = _local_1d(lambda v: compact.interp_1d(v, axis=1), grid, 1)(fz_i)
    c2 = _local_1d(lambda v: compact.grad_1d(v, dy, axis=1), grid, 1)(fz_i)
    c3 = _local_1d(lambda v: compact.interp_1d(v, axis=1), grid, 1)(fz_d)
    # X sweep (X-pencils)
    c1, c2, c3 = (to_pencil(c, grid, 0, from_dim=1) for c in (c1, c2, c3))
    g1 = _local_1d(lambda v: compact.grad_1d(v, dx, axis=0), grid, 0)(c1)
    g2 = _local_1d(lambda v: compact.interp_1d(v, axis=0), grid, 0)(c2)
    g3 = _local_1d(lambda v: compact.interp_1d(v, axis=0), grid, 0)(c3)
    return jnp.stack([from_pencil(g, grid, from_dim=0)
                      for g in (g1, g2, g3)], axis=-1)


def div(F: Array, grid) -> Array:
    """Distributed divergence of a vertex-located (nx, ny, nz, 3) field."""
    if getattr(grid, "uneven", False):
        return _uneven_fallback(
            lambda v: compact.div(v, grid.deltas), F, grid)
    dx, dy, dz = grid.deltas
    # X sweep (X-pencils)
    dvx = _local_1d(lambda v: compact.div_1d(v, dx, axis=0), grid, 0)
    itx = _local_1d(lambda v: compact.interp_1d_div(v, axis=0), grid, 0)
    e1 = dvx(to_pencil(F[..., 0], grid, 0, from_dim=None))
    e2 = itx(to_pencil(F[..., 1], grid, 0, from_dim=None))
    e3 = itx(to_pencil(F[..., 2], grid, 0, from_dim=None))
    # Y sweep (Y-pencils)
    dvy = _local_1d(lambda v: compact.div_1d(v, dy, axis=1), grid, 1)
    ity = _local_1d(lambda v: compact.interp_1d_div(v, axis=1), grid, 1)
    f1 = ity(to_pencil(e1, grid, 1, from_dim=0))
    f2 = dvy(to_pencil(e2, grid, 1, from_dim=0))
    f3 = ity(to_pencil(e3, grid, 1, from_dim=0))
    # Z sweep (Z-pencils)
    dvz = _local_1d(lambda v: compact.div_1d(v, dz, axis=2), grid, 2)
    itz = _local_1d(lambda v: compact.interp_1d_div(v, axis=2), grid, 2)
    s12 = to_pencil(f1 + f2, grid, 2, from_dim=1)
    out = itz(s12) + dvz(to_pencil(f3, grid, 2, from_dim=1))
    return from_pencil(out, grid, from_dim=2)


def lapl(f: Array, grid) -> Array:
    """Distributed 6th-order compact Laplacian div(grad(f))
    (reference src/compact_schemes.f90:17-37)."""
    if getattr(grid, "uneven", False):
        return _uneven_fallback(
            lambda v: compact.lapl(v, grid.deltas), f, grid)
    return div(grad(f, grid), grid)


def interp(f: Array, grid, stagger: int = -1) -> Array:
    """Distributed tri-directional interpolation, Z->Y->X (reference
    src/compact_schemes.f90:93-142)."""
    if getattr(grid, "uneven", False):
        return _uneven_fallback(
            lambda v: compact.interp(v, stagger=stagger), f, grid)
    out = f
    prev: int | None = None
    for d in (2, 1, 0):
        op = _local_1d(
            lambda v, d=d: compact.interp_1d(v, stagger=stagger, axis=d),
            grid, d)
        out = op(to_pencil(out, grid, d, from_dim=prev))
        prev = d
    return from_pencil(out, grid, from_dim=0)
