"""Explicitly distributed stencil operators — shard_map + ppermute halos.

This is the multi-device path: the direct analogue of the
reference's `DMGetLocalVector` + `DMGlobalToLocal` + owned-box loop
(reference src/poissbox.f90:104-126). Every operation is expressed in
*correction form*: each device runs the single-device roll formulation on
its local block with *local-periodic* wrap, while `lax.ppermute` fetches the
true neighbor planes; the sharded faces are then patched with the linear
correction `coeff * (halo_plane - wrapped_plane)`. Because the 7-point star
(and every smoother built from it) is linear in the input, the patch is
exact — and the bulk kernel is independent of the collectives, so XLA can
overlap the ppermutes with the interior compute (SURVEY.md §7 step 6).

Operations provided (all require the field sharded per `grid.spec`):
  * apply_laplacian_sharded      — y = A x
  * apply_laplacian_dot_sharded  — (A x, <x, A x>) with psum'd dot
  * residual_sharded             — r = b - A x
  * jacobi_sweep_sharded         — x + (w/diag)(b - A x)
  * sor_sweep_sharded            — one red-black color update

The single-color SOR update relies on the red-black parity being computable
from *local* indices, which holds iff every sharded dimension has an even
local extent (device offsets are then even); callers must check
`sor_parity_local_ok` and fall back to the global roll formulation
otherwise.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec

from poissbox_tpu.ops.stencil import apply_laplacian, laplacian_local
from poissbox_tpu.parallel.halo import _shift_perms, halo_pad_local


def _local_axis_names(grid) -> tuple:
    """Mesh axis name sharding each array dim (None where unsharded)."""
    spec = grid.spec
    names = list(spec) + [None] * (3 - len(spec))
    return tuple(names)


def local_shape(grid) -> tuple[int, int, int]:
    """Per-device block shape under the grid's sharding."""
    if grid.mesh is None:
        return tuple(grid.n)
    names = _local_axis_names(grid)
    return tuple(
        n // (grid.mesh.shape[nm] if nm is not None else 1)
        for n, nm in zip(grid.n, names))


def sor_parity_local_ok(grid) -> bool:
    """True iff red-black parity is locally computable: every sharded dim
    has an even local extent (so every device's global offset is even)."""
    if grid.mesh is None:
        return True
    names = _local_axis_names(grid)
    return all(
        (n // grid.mesh.shape[nm]) % 2 == 0
        for n, nm in zip(grid.n, names) if nm is not None
        and grid.mesh.shape[nm] > 1)


# ---------------------------------------------------------------------------
# correction-form machinery
# ---------------------------------------------------------------------------

def _halo_diffs(block: jax.Array, mesh, names) -> dict:
    """Per sharded dim d: (left_halo - wrapped_last, right_halo -
    wrapped_first) face planes. Issued first so the ppermutes are in
    flight while the bulk kernel runs."""
    diffs = {}
    for d in range(block.ndim):
        name = names[d] if d < len(names) else None
        if name is None or mesh.shape[name] == 1:
            continue
        n = block.shape[d]
        lo = lax.slice_in_dim(block, 0, 1, axis=d)
        hi = lax.slice_in_dim(block, n - 1, n, axis=d)
        fwd, bwd = _shift_perms(mesh.shape[name])
        left = lax.ppermute(hi, name, fwd)   # neighbor's last plane
        right = lax.ppermute(lo, name, bwd)  # neighbor's first plane
        diffs[d] = (left - hi, right - lo)
    return diffs


def _face_idx(shape, d: int, hi: bool):
    n = shape[d]
    sl = slice(n - 1, n) if hi else slice(0, 1)
    return tuple(sl if i == d else slice(None) for i in range(len(shape)))


def _apply_corrections(out: jax.Array, diffs: dict, invs, scale=1.0,
                       masks=None) -> jax.Array:
    """out += scale * inv_d^2 * (halo - wrapped) on each sharded face;
    `masks[d]` optionally gates the correction (red-black color faces)."""
    for d, (dlo, dhi) in diffs.items():
        c_lo = (scale * invs[d]) * dlo
        c_hi = (scale * invs[d]) * dhi
        if masks is not None:
            m_lo, m_hi = masks[d]
            c_lo = c_lo * m_lo
            c_hi = c_hi * m_hi
        out = out.at[_face_idx(out.shape, d, False)].add(c_lo)
        out = out.at[_face_idx(out.shape, d, True)].add(c_hi)
    return out


def _sharded(grid, fn):
    return jax.shard_map(fn, mesh=grid.mesh, in_specs=grid.spec,
                         out_specs=grid.spec)


# ---------------------------------------------------------------------------
# operator application
# ---------------------------------------------------------------------------

def apply_laplacian_sharded(u: jax.Array, grid,
                            overlap: bool = True) -> jax.Array:
    """Periodic 7-point Laplacian of a sharded field via explicit halos.

    overlap=True (default) is the correction form described in the module
    docstring; overlap=False pads the local block with `halo_pad_local`
    and applies the star to the padded block (the literal DMGlobalToLocal
    shape, kept as an independent cross-check implementation).
    """
    if grid.mesh is None:
        return laplacian_local(jnp.pad(u, 1, mode="wrap"), grid.deltas)
    names = _local_axis_names(grid)
    mesh = grid.mesh
    deltas = grid.deltas

    if not overlap:
        @partial(jax.shard_map, mesh=mesh, in_specs=grid.spec,
                 out_specs=grid.spec)
        def _apply(block):
            padded = halo_pad_local(block, mesh, names, width=1)
            return laplacian_local(padded, deltas)

        return _apply(u)

    invs = [1.0 / float(d) ** 2 for d in deltas]

    def _apply_overlap(block):
        diffs = _halo_diffs(block, mesh, names)       # collectives first
        out = apply_laplacian(block, deltas)          # overlappable bulk
        return _apply_corrections(out, diffs, invs)

    return _sharded(grid, _apply_overlap)(u)


def apply_laplacian_dot_sharded(u: jax.Array, grid):
    """(A u, <u, A u>) in one sharded pass: the local matvec and dot plus
    the face-correction terms, dot psum'd over the mesh."""
    names = _local_axis_names(grid)
    mesh = grid.mesh
    deltas = grid.deltas
    invs = [1.0 / float(d) ** 2 for d in deltas]
    axes = tuple(n for n in set(names) if n is not None
                 and mesh.shape[n] > 1)

    def _apply(block):
        diffs = _halo_diffs(block, mesh, names)
        out = apply_laplacian(block, deltas)
        dot = jnp.sum(block * out)
        # dot correction: <u, A_true u> = <u, A_loc u> + sum_faces u * corr
        for d, (dlo, dhi) in diffs.items():
            u_lo = block[_face_idx(block.shape, d, False)]
            u_hi = block[_face_idx(block.shape, d, True)]
            dot = dot + invs[d] * (jnp.sum(u_lo * dlo) + jnp.sum(u_hi * dhi))
        out = _apply_corrections(out, diffs, invs)
        return out, (lax.psum(dot, axes) if axes else dot)

    fn = jax.shard_map(_apply, mesh=mesh, in_specs=grid.spec,
                       out_specs=(grid.spec, PartitionSpec()))
    return fn(u)


def residual_sharded(x: jax.Array, b: jax.Array, grid) -> jax.Array:
    """r = b - A x (local residual + face corrections)."""
    names = _local_axis_names(grid)
    mesh = grid.mesh
    deltas = grid.deltas
    invs = [1.0 / float(d) ** 2 for d in deltas]

    def _res(xb, bb):
        diffs = _halo_diffs(xb, mesh, names)
        r = bb - apply_laplacian(xb, deltas)
        # r_true = r_loc - corr
        return _apply_corrections(r, diffs, invs, scale=-1.0)

    return _sharded(grid, _res)(x, b)


# ---------------------------------------------------------------------------
# smoother sweeps
# ---------------------------------------------------------------------------

def jacobi_sweep_sharded(x: jax.Array, b: jax.Array, grid,
                         weight: float) -> jax.Array:
    """Damped-Jacobi sweep x + (w/diag)(b - A x) on a sharded field."""
    names = _local_axis_names(grid)
    mesh = grid.mesh
    deltas = grid.deltas
    invs = [1.0 / float(d) ** 2 for d in deltas]
    winv = float(weight) / (-2.0 * sum(invs))

    def _sweep(xb, bb):
        diffs = _halo_diffs(xb, mesh, names)
        out = xb + winv * (bb - apply_laplacian(xb, deltas))
        # x'_true = x'_loc - winv * corr
        return _apply_corrections(out, diffs, invs, scale=-winv)

    return _sharded(grid, _sweep)(x, b)


def _face_color_masks(shape, diffs, color: int, dtype) -> dict:
    """Red-black masks for the sharded face planes, from local indices
    (valid when `sor_parity_local_ok`)."""
    masks = {}
    for d in diffs:
        def face_mask(hi: bool, d=d):
            fshape = tuple(1 if i == d else shape[i]
                           for i in range(len(shape)))
            par = (shape[d] - 1) % 2 if hi else 0
            for i in range(len(shape)):
                if i == d:
                    continue
                par = par + lax.broadcasted_iota(jnp.int32, fshape, i)
            return ((par % 2) == color).astype(dtype)
        masks[d] = (face_mask(False), face_mask(True))
    return masks


def sor_sweep_sharded(x: jax.Array, b: jax.Array, grid, weight: float,
                      color: int) -> jax.Array:
    """One red-black SOR color update (color 0 = red, (i+j+k) even) on a
    sharded field. Requires `sor_parity_local_ok(grid)`."""
    if not sor_parity_local_ok(grid):
        raise ValueError(
            "sharded red-black SOR needs even local extents on every "
            f"sharded dim (grid {grid.n} over {dict(grid.mesh.shape)})")
    names = _local_axis_names(grid)
    mesh = grid.mesh
    deltas = grid.deltas
    invs = [1.0 / float(d) ** 2 for d in deltas]
    winv = float(weight) / (-2.0 * sum(invs))

    def _sweep(xb, bb):
        diffs = _halo_diffs(xb, mesh, names)
        ii = lax.broadcasted_iota(jnp.int32, xb.shape, 0)
        jj = lax.broadcasted_iota(jnp.int32, xb.shape, 1)
        kk = lax.broadcasted_iota(jnp.int32, xb.shape, 2)
        mask = (((ii + jj + kk) % 2) == color).astype(xb.dtype)
        out = xb + (winv * mask) * (bb - apply_laplacian(xb, deltas))
        masks = _face_color_masks(xb.shape, diffs, color, xb.dtype)
        # x'_true = x'_loc - winv * mask * corr
        return _apply_corrections(out, diffs, invs, scale=-winv, masks=masks)

    return _sharded(grid, _sweep)(x, b)
