"""Periodic halo exchange over the device mesh.

Replaces PETSc's ghost update `DMGetLocalVector` + `DMGlobalToLocal`
(reference src/poissbox.f90:104-105). Two modes:

  * **GSPMD (automatic):** operators written with `jnp.roll` on globally
    shaped sharded arrays; XLA partitions them and inserts the
    collective-permutes itself. No code in this module is involved.

  * **Explicit (`shard_map`):** `halo_pad_local` runs *inside* a
    `jax.shard_map` body and pads the device-local block with neighbor
    planes via `lax.ppermute`, falling back to a local periodic
    wrap on unsharded axes. Padding axes sequentially routes edge/corner
    halo data through two hops, so the padded block is correct for full
    box stencils (the reference uses DMDA_STENCIL_BOX, src/poissbox.f90:193),
    though the 7-point star itself only consumes face halos.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax


def _shift_perms(size: int):
    """ppermute permutations for periodic right-shift and left-shift."""
    fwd = [(i, (i + 1) % size) for i in range(size)]  # data moves +1 along axis
    bwd = [(i, (i - 1) % size) for i in range(size)]  # data moves -1 along axis
    return fwd, bwd


def halo_pad_local(
    u: jax.Array,
    mesh: jax.sharding.Mesh,
    axis_names: Sequence[str | None],
    width: int = 1,
    dims: Sequence[int] | None = None,
) -> jax.Array:
    """Pad a device-local block with periodic halos of `width` planes.

    Must be called inside a `shard_map` over `mesh`. `axis_names[d]` is the
    mesh axis name sharding array dimension `d` (None = unsharded). Returns
    the block grown by 2*width along each dim in `dims` (default: all).
    """
    dims = range(u.ndim) if dims is None else dims
    for d in dims:
        name = axis_names[d] if d < len(axis_names) else None
        n = u.shape[d]
        if width > n:
            raise ValueError(f"halo width {width} exceeds local extent {n} on dim {d}")
        lo = lax.slice_in_dim(u, 0, width, axis=d)
        hi = lax.slice_in_dim(u, n - width, n, axis=d)
        if name is None or mesh.shape[name] == 1:
            left_halo, right_halo = hi, lo  # periodic wrap within the block
        else:
            fwd, bwd = _shift_perms(mesh.shape[name])
            # device j's left halo = device j-1's trailing planes (periodic)
            left_halo = lax.ppermute(hi, name, fwd)
            right_halo = lax.ppermute(lo, name, bwd)
        u = jnp.concatenate([left_halo, u, right_halo], axis=d)
    return u


def halo_exchange_spec(mesh: jax.sharding.Mesh, axis_names: Sequence[str | None]):
    """Static description of the exchange: per-dim (mesh axis, size) pairs.

    Useful for cost models and tests; the exchange itself is `halo_pad_local`.
    """
    return tuple(
        (name, mesh.shape[name] if name is not None else 1) for name in axis_names
    )
