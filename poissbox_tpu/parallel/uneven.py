"""Non-divisible (uneven) domain decomposition — pad-and-mask execution.

PETSc's DMDA runs any process count over any grid: 64^3 on 3 ranks is the
reference's canonical demo, with the 90112/86016/86016 DoF split (reference
README.md:25-33, src/poissbox.f90:191-200 PETSC_DECIDE). XLA's GSPMD, by
contrast, requires every sharded axis to divide evenly (`jax.device_put`
raises otherwise). This module closes that gap with a layout:

  * fields live in a **padded layout**: each sharded axis of global extent
    `n` over `p` devices is stored with extent `p * L`, `L = ceil(n/p)`;
    device `i` owns `c_i` valid cells (DMDA convention: leading devices take
    the remainder, matching `parallel.decomp.owned_boxes`) followed by
    `L - c_i` zero pad cells. Execution ownership therefore matches the
    reported DoF distribution exactly (90112/86016/86016 for 64^3 on 3).
  * periodic neighbor access is a **roll plus static seam fixes**: rolling
    the padded array is correct everywhere except at the `p - rem` device
    boundaries where a pad plane intervenes; those positions are patched by
    copying the true neighbor plane (a static-index plane copy that GSPMD
    lowers to the same point-to-point transfer a halo exchange uses).
  * operator outputs are **masked** so pad cells stay identically zero;
    sums/dots/norms over padded fields are then exact, and Krylov solvers
    run unchanged. The null-space projection uses the *logical* cell count
    (`ndof`, not the padded size) and re-masks — see
    :func:`make_masked_projector`.

Performance note: this path trades a few extra plane copies per operator
application for generality; the evenly-divisible fast path
(`parallel.dist_stencil`, correction-form shard_map) is unaffected and
remains the default whenever the decomposition divides.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# layout planning (static, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def axis_plan(n: int, p: int):
    """Padded-layout plan for one axis: (L, counts, starts, fixes_plus,
    fixes_minus).

    L is the per-device padded extent; counts the valid cells per device
    (DMDA remainder convention, identical to `decomp.owned_boxes`); starts
    the padded-global offset of each device's block. fixes_plus/minus are
    the (dst, src) plane pairs that repair `roll(-1)` / `roll(+1)` at seams
    where a pad plane intervenes (empty when p divides n).
    """
    if p <= 1:
        return n, (n,), (0,), (), ()
    base, rem = divmod(n, p)
    if rem == 0:
        return base, (base,) * p, tuple(i * base for i in range(p)), (), ()
    L = base + 1
    counts = tuple(base + 1 if i < rem else base for i in range(p))
    starts = tuple(i * L for i in range(p))
    ends = tuple(starts[i] + counts[i] - 1 for i in range(p))
    fixes_plus = tuple(
        (ends[i], starts[(i + 1) % p]) for i in range(p) if counts[i] < L)
    fixes_minus = tuple(
        (starts[i], ends[(i - 1) % p]) for i in range(p)
        if counts[(i - 1) % p] < L)
    return L, counts, starts, fixes_plus, fixes_minus


def grid_pgrid(grid) -> tuple[int, int, int]:
    if grid.mesh is None:
        return (1, 1, 1)
    return tuple(grid.mesh.shape[name] for name in grid.axis_names)


def padded_shape(n: Sequence[int], pgrid: Sequence[int]) -> tuple[int, ...]:
    return tuple(p * axis_plan(nd, p)[0] for nd, p in zip(n, pgrid))


def is_uneven(n: Sequence[int], pgrid: Sequence[int]) -> bool:
    return any(nd % p for nd, p in zip(n, pgrid))


def _axis_valid_and_gidx(nd: int, p: int):
    """(valid_1d bool, global_index_1d int32) for one axis, computed with
    jnp from iotas — NOT a baked host table: an O(n^3) literal would ship
    with every compiled program (1.7 GB at 768^3-class uneven grids); the
    iota form costs XLA a negligible folded computation instead."""
    L, counts, starts, _, _ = axis_plan(nd, p)
    base, rem = divmod(nd, p)
    q = jnp.arange(p * L, dtype=jnp.int32)
    dev = q // L
    j = q - dev * L
    valid = j < (base + (dev < rem).astype(jnp.int32))
    gidx = dev * base + jnp.minimum(dev, rem) + j
    return valid, gidx


def valid_mask(grid, dtype) -> jax.Array:
    """0/1 mask of the padded shape marking valid (owned) cells."""
    pg = grid_pgrid(grid)
    m = None
    for d, (nd, p) in enumerate(zip(grid.n, pg)):
        v, _ = _axis_valid_and_gidx(nd, p)
        sh = [1, 1, 1]
        sh[d] = -1
        vd = v.astype(dtype).reshape(sh)
        m = vd if m is None else m * vd
    return m


def color_mask(grid, color: int, dtype) -> jax.Array:
    """Red-black parity mask from *global* indices, times the valid mask.

    Parity is a property of the logical grid, not the padded layout; pad
    cells are always 0 regardless of color."""
    pg = grid_pgrid(grid)
    par = None
    valid = None
    for d, (nd, p) in enumerate(zip(grid.n, pg)):
        v, g = _axis_valid_and_gidx(nd, p)
        sh = [1, 1, 1]
        sh[d] = -1
        gd = g.reshape(sh)
        vd = v.astype(dtype).reshape(sh)
        par = gd if par is None else par + gd
        valid = vd if valid is None else valid * vd
    return ((par % 2) == color).astype(dtype) * valid


# ---------------------------------------------------------------------------
# layout conversion
# ---------------------------------------------------------------------------

def to_padded(f: jax.Array, grid) -> jax.Array:
    """Scatter a logical-(nx,ny,nz) field into the padded layout (pads 0)."""
    pg = grid_pgrid(grid)
    for d, (nd, p) in enumerate(zip(grid.n, pg)):
        L, counts, _, _, _ = axis_plan(nd, p)
        if p * L == nd:
            continue
        chunks = []
        g = 0
        for c in counts:
            blk = lax.slice_in_dim(f, g, g + c, axis=d)
            if c < L:
                pad = [(0, 0)] * f.ndim
                pad[d] = (0, L - c)
                blk = jnp.pad(blk, pad)
            chunks.append(blk)
            g += c
        f = jnp.concatenate(chunks, axis=d)
    return f


def from_padded(fp: jax.Array, grid) -> jax.Array:
    """Gather the valid cells back to the logical (nx,ny,nz) field."""
    pg = grid_pgrid(grid)
    for d, (nd, p) in enumerate(zip(grid.n, pg)):
        L, counts, starts, _, _ = axis_plan(nd, p)
        if p * L == nd:
            continue
        chunks = [
            lax.slice_in_dim(fp, s, s + c, axis=d)
            for s, c in zip(starts, counts)
        ]
        fp = jnp.concatenate(chunks, axis=d)
    return fp


# ---------------------------------------------------------------------------
# periodic shifts on the padded layout
# ---------------------------------------------------------------------------

def shift_padded(u: jax.Array, axis: int, shift: int, grid) -> jax.Array:
    """out[q] = u[global neighbor of q at distance `shift`] for valid q.

    `shift=+1` fetches the +1 (next) periodic neighbor, `-1` the previous.
    Pad positions of the output are unspecified (callers mask). The bulk is
    a plain roll (GSPMD turns the wrap into the usual halo collective); the
    `p - rem` seam planes where padding intervenes are then patched with
    static-index plane copies.
    """
    if shift not in (1, -1):
        raise ValueError(f"shift must be +-1, got {shift}")
    nd, p = grid.n[axis], grid_pgrid(grid)[axis]
    L, counts, starts, fplus, fminus = axis_plan(nd, p)
    out = jnp.roll(u, -shift, axis)
    fixes = fplus if shift == 1 else fminus
    for dst, src in fixes:
        plane = lax.slice_in_dim(u, src, src + 1, axis=axis)
        out = lax.dynamic_update_slice_in_dim(out, plane, dst, axis)
    return out


# ---------------------------------------------------------------------------
# masked stencil operators (7-point star, reference src/poissbox.f90:84-148)
# ---------------------------------------------------------------------------

def apply_laplacian_uneven(u: jax.Array, grid) -> jax.Array:
    """Periodic 2nd-order 7-point Laplacian on a padded uneven field.

    Output is masked: pad cells are exactly zero, valid cells match the
    unsharded operator on the logical field (tests/test_uneven.py).
    """
    deltas = grid.deltas
    acc = None
    center = 0.0
    for ax, dd in enumerate(deltas):
        inv = 1.0 / float(dd) ** 2
        term = (shift_padded(u, ax, 1, grid)
                + shift_padded(u, ax, -1, grid)) * inv
        acc = term if acc is None else acc + term
        center += 2.0 * inv
    return (acc - center * u) * valid_mask(grid, u.dtype)


def residual_uneven(x: jax.Array, b: jax.Array, grid) -> jax.Array:
    """r = b - A x (valid b in, valid r out)."""
    return b - apply_laplacian_uneven(x, grid)


def jacobi_sweep_uneven(x: jax.Array, b: jax.Array, grid,
                        weight: float) -> jax.Array:
    invs = [1.0 / float(d) ** 2 for d in grid.deltas]
    winv = float(weight) / (-2.0 * sum(invs))
    return x + winv * (b - apply_laplacian_uneven(x, grid))


def sor_sweep_uneven(x: jax.Array, b: jax.Array, grid, weight: float,
                     color: int) -> jax.Array:
    """One red-black color update; parity from global (logical) indices."""
    invs = [1.0 / float(d) ** 2 for d in grid.deltas]
    winv = float(weight) / (-2.0 * sum(invs))
    cm = color_mask(grid, color, x.dtype)
    return x + (winv * cm) * (b - apply_laplacian_uneven(x, grid))


def make_masked_projector(grid):
    """Null-space projector for padded fields: x - (sum x / ndof) * mask.

    The mean uses the LOGICAL cell count (pads are zero so the sum is
    already exact), and the subtraction is masked so pads stay zero — the
    MatNullSpace semantics (reference src/poissbox.f90:284-291) on the
    padded layout. Deliberately NOT marked `is_constant_projector`: the
    solvers' folded rank-one projection divides by the padded size and
    shifts pad cells, so uneven operators take the explicit path.
    """
    inv_n = 1.0 / float(grid.ndof)

    def project(x: jax.Array) -> jax.Array:
        m = valid_mask(grid, x.dtype)
        return x - (jnp.sum(x) * inv_n) * m

    return project
