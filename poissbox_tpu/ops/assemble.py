"""Assembled stencil-operator view — the DMCreateMatrix/MatSetValuesStencil
replacement.

The reference assembles the 7-point Laplacian into a distributed AIJ matrix
(per-cell `MatSetValuesStencil` of the flattened 3x3x3 box, reference
src/coefficients.f90:50-113) and keeps it alongside the matrix-free shell
(`KSPSetOperators(ksp, A, P)` applies A, preconditions from P, reference
src/poissbox.f90:294). For a structured grid an explicit sparse AIJ matrix
is the wrong data structure — SpMV via gather/scatter wastes bandwidth on
indices — so the assembled
view is a :class:`StencilMatrix`: the (3,3,3) coefficient box (optionally
spatially varying) stored explicitly, applied as a dense shift-and-scale
contraction, convertible to a dense matrix for coarse/direct solves. This
preserves every capability the assembled path serves in the reference
(feeding the preconditioner setup, operator introspection, A-vs-P
cross-checks) in array form.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from poissbox_tpu.ops.coefficients import lapl_star_coeffs

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class StencilMatrix:
    """An assembled constant-coefficient 3x3x3 box-stencil operator.

    Attributes:
      box: (3, 3, 3) coefficient box, center at [1, 1, 1] (the reference's
        `lapl_star_coeffs` layout, src/coefficients.f90:38-48).
      shape: grid shape the operator acts on.
    """

    box: Array
    shape: tuple[int, int, int]

    def __call__(self, u: Array) -> Array:
        return self.apply(u)

    def apply(self, u: Array) -> Array:
        """y = M u by periodic shift-and-scale over the 27 box entries
        (zero entries dropped at trace time — the reference pushes all 27
        including the 20 zeros, src/coefficients.f90:89-105)."""
        if u.shape != self.shape:
            raise ValueError(f"field shape {u.shape} != operator shape {self.shape}")
        box = np.asarray(self.box)
        out = jnp.zeros_like(u)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    c = box[di + 1, dj + 1, dk + 1]
                    if c == 0.0:
                        continue
                    out = out + c * jnp.roll(u, (-di, -dj, -dk), axis=(0, 1, 2))
        return out

    def diagonal(self) -> Array:
        return self.box[1, 1, 1]

    def row(self, i: int, j: int, k: int) -> dict[tuple[int, int, int], float]:
        """Nonzero (column-offset -> value) entries of one matrix row —
        MatGetRow-style introspection."""
        box = np.asarray(self.box)
        nx, ny, nz = self.shape
        # accumulate: on an axis of extent <= 2 the periodic +1/-1 offsets
        # wrap onto the same column, so their coefficients must sum
        out: dict[tuple[int, int, int], float] = {}
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    v = float(box[di + 1, dj + 1, dk + 1])
                    if v == 0.0:
                        continue
                    key = ((i + di) % nx, (j + dj) % ny, (k + dk) % nz)
                    out[key] = out.get(key, 0.0) + v
        return out

    def to_dense(self) -> np.ndarray:
        """Dense (N, N) matrix, N = prod(shape). For coarse/direct solves
        and tests only."""
        nx, ny, nz = self.shape
        N = nx * ny * nz
        A = np.zeros((N, N))
        box = np.asarray(self.box)
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    r = (i * ny + j) * nz + k
                    for cols, v in self.row(i, j, k).items():
                        ci, cj, ck = cols
                        A[r, (ci * ny + cj) * nz + ck] += v
        return A

    def nnz_per_row(self) -> int:
        return int((np.asarray(self.box) != 0.0).sum())


def assemble_laplacian(shape: Sequence[int], deltas: Sequence[float],
                       dtype=None) -> StencilMatrix:
    """Assemble the periodic 7-point Laplacian (reference
    src/coefficients.f90:50-113, minus the per-point recomputation and the
    20 explicit zeros)."""
    dx, dy, dz = deltas
    box = lapl_star_coeffs(dx, dy, dz, dtype=dtype)
    return StencilMatrix(box=box, shape=tuple(shape))
