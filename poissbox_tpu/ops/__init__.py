"""Numerical operator kernels: stencils, tridiagonal solves, compact schemes.

Pure-XLA formulations (stencil, tridiag, compact, compact_pcr, assemble)
and the distributed pencil-transposed compact operators (compact_dist).
"""

from poissbox_tpu.ops import (
    assemble,
    coefficients,
    compact,
    compact_dist,
    stencil,
    tridiag,
)

__all__ = ["assemble", "coefficients", "compact", "compact_dist",
           "stencil", "tridiag"]
