"""3-D process-grid decomposition — the PETSC_DECIDE analogue.

The reference delegates choosing the process grid and each rank's owned box
to PETSc's DMDA (`DMDACreate3d` with `PETSC_DECIDE` for the processor counts,
reference src/poissbox.f90:191-200; owned boxes queried via `DMDAGetCorners`,
src/poissbox.f90:107). That logic lives in PETSc's native C layer. Here it
is a small, exactly-specified algorithm with two implementations:

  * a pure-Python reference implementation (always available), and
  * a C++ implementation (poissbox_tpu/native) loaded via ctypes when the
    shared library has been built — exercised by the same tests.

Given `ndev` devices and a global grid (nx, ny, nz), `decompose_3d` returns
the (px, py, pz) factorization minimizing total halo surface, subject to
each factor dividing the grid evenly when possible (XLA shards evenly-
divisible axes without padding, so we prefer exact divisibility).
"""

from __future__ import annotations

import itertools
from typing import Sequence


def _factor_triples(n: int):
    """All ordered triples (a, b, c) with a*b*c == n."""
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            yield (a, b, m // b)


def decompose_3d(ndev: int, shape: Sequence[int]) -> tuple[int, int, int]:
    """Choose a process grid (px, py, pz) for `ndev` devices on grid `shape`.

    Dispatches to the native C++ planner when built (identical semantics,
    cross-checked by tests/test_native.py); the Python path below is the
    always-available reference implementation.

    Objective mirrors DMDA's heuristic: minimize communication surface
    2*(sx*sy + sy*sz + sz*sx) of the per-device sub-box (sx, sy, sz), with a
    hard preference for decompositions that divide the grid exactly and for
    putting parallelism on the slowest-varying axes first (keeps the
    innermost, contiguous axis whole).
    """
    try:
        from poissbox_tpu import native
        if native.available():
            return native.decompose_3d(ndev, shape)
    except Exception:
        pass  # fall through to the Python implementation
    nx, ny, nz = shape
    best = None
    for (px, py, pz) in _factor_triples(ndev):
        if px > nx or py > ny or pz > nz:
            continue
        exact = (nx % px == 0) and (ny % py == 0) and (nz % pz == 0)
        sx, sy, sz = -(-nx // px), -(-ny // py), -(-nz // pz)
        surface = 2.0 * (sx * sy * (pz > 1) + sy * sz * (px > 1) + sz * sx * (py > 1))
        # tie-break: prefer splitting x (slowest-varying, halo planes are
        # large contiguous blocks), then y, and keep z (lane axis) whole.
        key = (not exact, surface, pz, py, px)
        if best is None or key < best[0]:
            best = (key, (px, py, pz))
    if best is None:
        raise ValueError(f"cannot decompose {ndev} devices over grid {tuple(shape)}")
    return best[1]


def owned_boxes(shape: Sequence[int], pgrid: Sequence[int]):
    """Owned-box (start, count) per process coordinate — DMDAGetCorners analogue.

    Returns a dict mapping (ix, iy, iz) process coordinates to
    ((xs, ys, zs), (xn, yn, zn)). Remainder cells are given to the leading
    processes on each axis, matching XLA's sharding of non-divisible axes
    (and PETSc's convention closely enough for DoF accounting).
    """
    out = {}
    starts_counts = []
    for n, p in zip(shape, pgrid):
        base, rem = divmod(n, p)
        counts = [base + (1 if i < rem else 0) for i in range(p)]
        starts = [sum(counts[:i]) for i in range(p)]
        starts_counts.append(list(zip(starts, counts)))
    for (ix, iy, iz) in itertools.product(*(range(p) for p in pgrid)):
        xs, xn = starts_counts[0][ix]
        ys, yn = starts_counts[1][iy]
        zs, zn = starts_counts[2][iz]
        out[(ix, iy, iz)] = ((xs, ys, zs), (xn, yn, zn))
    return out


def dof_distribution(shape: Sequence[int], pgrid: Sequence[int]) -> list[int]:
    """Per-device DoF counts (the reference README reports 90112/86016/86016
    for 64^3 on 3 ranks, reference README.md:25-33)."""
    return [
        xn * yn * zn
        for (_, (_, (xn, yn, zn))) in sorted(owned_boxes(shape, pgrid).items())
    ]
