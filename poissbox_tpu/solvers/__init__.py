"""Krylov + multigrid solvers — the KSP/PC replacement.

The reference configures and runs PETSc's KSP with a preconditioner chosen
from the options database (reference src/poissbox.f90:269-298,
README.md:42-49). Here the same capability surface is pure JAX:

  - solvers.cg ......... conjugate gradients (the recommended `-ksp_type cg`)
  - solvers.pipecg ..... pipelined CG, one overlapped reduction/iteration
                         (PETSc KSPPIPECG — for latency-bound meshes)
  - solvers.gmres ...... restarted GMRES (PETSc's default KSP type)
  - solvers.richardson . damped Richardson iteration (MG level solver)
  - solvers.mg ......... geometric-multigrid V-cycle preconditioner
                         (replaces `-pc_type gamg` — the grid is structured,
                         so GMG is the idiomatic equivalent)
  - solvers.ksp ........ options-driven dispatcher (KSPSetFromOptions analog)
  - solvers.refine ..... mixed-precision iterative refinement (f32 inner
                         solves, f64 true residuals — the fast route
                         to the reference's double-precision accuracy)
  - solvers.fft ........ FFT direct solve for the fully periodic case
                         (exact spectral inverse of the discrete operator;
                         no reference analogue)

All solvers are jit-compatible (`lax.while_loop` outer iterations, psum-style
global reductions via jnp on sharded arrays), handle the singular periodic
system through the operator's null-space projector, and return a
:class:`SolveResult` carrying the residual history (the `-ksp_monitor`
analog, reference README.md:48-49).
"""

from poissbox_tpu.solvers.result import SolveResult, ConvergedReason
from poissbox_tpu.solvers.cg import cg
from poissbox_tpu.solvers.pipecg import pipecg
from poissbox_tpu.solvers.gmres import gmres
from poissbox_tpu.solvers.richardson import richardson
from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner, v_cycle
from poissbox_tpu.solvers.ksp import solve, make_solver
from poissbox_tpu.solvers.refine import RefineResult, refine
from poissbox_tpu.solvers.fft import poisson_solve_fft

__all__ = [
    "SolveResult",
    "ConvergedReason",
    "cg",
    "pipecg",
    "gmres",
    "richardson",
    "MGConfig",
    "make_mg_preconditioner",
    "v_cycle",
    "solve",
    "make_solver",
    "refine",
    "RefineResult",
    "poisson_solve_fft",
]
