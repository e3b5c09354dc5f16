"""poissbox_tpu — a structured-grid Poisson-solver framework.

A from-scratch JAX/XLA re-design of the capability surface of
3decomp/poissbox (reference: /root/reference): distributed structured-grid
management, matrix-free stencil operators, Krylov + geometric-multigrid
solution of singular (periodic) Poisson systems, a runtime options system,
6th-order staggered compact finite-difference operators built on batched
periodic tridiagonal solves, and the accompanying verification methodology.

Where the reference composes MPI + PETSc (DMDA/Vec/Mat/KSP/PC) under
Fortran, this framework composes a `jax.sharding.Mesh` + sharded arrays +
pure functions under `jit`:

  - grids / decomposition .... poissbox_tpu.mesh        (replaces DMDA)
  - halo exchange ............ poissbox_tpu.parallel    (replaces DMGlobalToLocal)
  - stencil operators ........ poissbox_tpu.ops.stencil (replaces MatShell/MatMult)
  - matrix assembly .......... poissbox_tpu.ops.assemble(replaces MatSetValuesStencil)
  - tridiagonal solvers ...... poissbox_tpu.ops.tridiag (replaces tridsol.f90)
  - compact schemes .......... poissbox_tpu.ops.compact (replaces compact_schemes.f90)
  - Krylov solvers ........... poissbox_tpu.solvers     (replaces KSP)
  - multigrid precondition ... poissbox_tpu.solvers.mg  (replaces PC/GAMG)
  - options database ......... poissbox_tpu.config      (replaces PETSc options DB)

Precision note: the reference runs entirely in double precision
(`pb_dp = kind(0.0d0)`, reference src/constants.f90:15). Double precision in
JAX requires `jax.config.update("jax_enable_x64", True)` *before* first use;
call :func:`poissbox_tpu.enable_x64` early, or set JAX_ENABLE_X64=1. The
framework itself is dtype-polymorphic — kernels follow their input dtypes —
so the single-precision fast path works unchanged.
"""

from poissbox_tpu.constants import enable_x64, default_real
from poissbox_tpu.mesh import Grid3D, init_distributed, make_device_mesh
from poissbox_tpu.linops import LinearOperator, make_nullspace_projector
from poissbox_tpu.config import Options

__version__ = "0.1.0"

__all__ = [
    "enable_x64",
    "init_distributed",
    "default_real",
    "Grid3D",
    "make_device_mesh",
    "LinearOperator",
    "make_nullspace_projector",
    "Options",
    "__version__",
]
