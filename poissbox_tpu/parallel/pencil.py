"""Pencil repartitioning for distributed line solves — the transpose method.

The compact schemes couple a whole grid line through a periodic tridiagonal
solve (reference src/compact_schemes.f90:197,312); the reference only ever
runs them on unsharded whole-domain arrays, serially over the n^2 pencils
(reference src/compact_schemes.f90:60-66). Distributing them is this
framework's "sequence parallelism" analogue (SURVEY.md §5.7), and the
namesake idea of the 2decomp/3decomp family the reference belongs to:
keep each solve line *device-local* by repartitioning the field between
sweeps — X-pencils -> Y-pencils -> Z-pencils — instead of parallelizing the
recurrence across devices.

Formulation: a pencil layout is just a `PartitionSpec` with the
solve dimension unsharded; the transpose is
`jax.lax.with_sharding_constraint` to that spec, which XLA lowers to the
minimal all-to-all. Mesh axes displaced from the solve dimension
ride along on the other dims, so total parallelism is conserved (a (px, py)
mesh keeps px*py-way sharding in every pencil orientation, exactly like
2decomp's 2-D processor grid).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec


def pencil_spec(grid, local_dim: int) -> PartitionSpec:
    """PartitionSpec with `local_dim` unsharded and every mesh axis kept.

    Mesh axes whose home dim is `local_dim` are appended to the next dim
    (cyclically), so e.g. a ('x','y') mesh over dims (0,1) gives
    X-pencils (local_dim=0) the spec (None, ('y','x'), None).
    """
    if grid.mesh is None:
        return PartitionSpec()
    home = list(grid.spec) + [None] * (3 - len(grid.spec))
    out: list[list[str]] = [[] for _ in range(3)]
    for d in range(3):
        entry = home[d]
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        target = d if d != local_dim else (d + 1) % 3
        if target == local_dim:  # single-dim corner case
            target = (d + 2) % 3
        out[target].extend(names)
    return PartitionSpec(*(
        None if not names else (names[0] if len(names) == 1 else tuple(names))
        for names in out
    ))


def _entries(spec) -> list[list[str]]:
    ents = list(spec) + [None] * (3 - len(spec))
    out = []
    for e in ents:
        if e is None:
            out.append([])
        elif isinstance(e, tuple):
            out.append(list(e))
        else:
            out.append([e])
    return out


def _as_spec(entries) -> PartitionSpec:
    return PartitionSpec(*(
        None if not names else (names[0] if len(names) == 1 else tuple(names))
        for names in entries))


def reshard_chain(f: jax.Array, mesh, from_spec: PartitionSpec,
                  to_spec: PartitionSpec) -> jax.Array:
    """Reshard from one layout to another via single-mesh-axis moves.

    XLA's SPMD partitioner lowers a resharding that moves ONE mesh axis
    between two array dims to an all-to-all, but falls back to full
    rematerialization (replicate + re-slice) when several axes migrate at
    once. Decomposing the pencil transposes into single-axis steps keeps
    every hop an all-to-all — the 2decomp transpose schedule.
    """
    cur = _entries(from_spec)
    dst = _entries(to_spec)
    steps: list[PartitionSpec] = []
    for d in range(3):
        for n in dst[d]:
            src = next(i for i, names in enumerate(cur) if n in names)
            if src == d:
                continue
            cur[src].remove(n)
            cur[d].append(n)
            steps.append(_as_spec(cur))
    if not steps or steps[-1] != _as_spec(dst):
        steps.append(_as_spec(dst))  # within-dim order fix-up / no-op guard
    for s in steps:
        f = jax.lax.with_sharding_constraint(f, NamedSharding(mesh, s))
    return f


def to_pencil(f: jax.Array, grid, local_dim: int,
              from_dim: int | None = -1) -> jax.Array:
    """Repartition so lines along `local_dim` are device-local (the
    2decomp transpose; all-to-alls under GSPMD).

    `from_dim` names the current layout when known — a previous pencil
    orientation (0/1/2) or None for the home layout — enabling the
    single-axis-move chain; -1 (unknown) issues one direct constraint.
    """
    if grid.mesh is None:
        return f
    spec = pencil_spec(grid, local_dim)
    if from_dim == -1:
        return jax.lax.with_sharding_constraint(
            f, NamedSharding(grid.mesh, spec))
    src = grid.spec if from_dim is None else pencil_spec(grid, from_dim)
    return reshard_chain(f, grid.mesh, src, spec)


def from_pencil(f: jax.Array, grid, from_dim: int | None = -1) -> jax.Array:
    """Restore the grid's home sharding."""
    if grid.mesh is None:
        return f
    if from_dim == -1:
        return jax.lax.with_sharding_constraint(
            f, NamedSharding(grid.mesh, grid.spec))
    return reshard_chain(f, grid.mesh, pencil_spec(grid, from_dim),
                         grid.spec)


def apply_along_axis(op, f: jax.Array, grid, axis: int) -> jax.Array:
    """Run a line operator `op(f, axis=...)` with its axis device-local:
    transpose in, solve locally (pencils batched on the VPU), stay in
    pencil layout for the caller to chain further sweeps."""
    fp = to_pencil(f, grid, axis)
    return op(fp, axis)
