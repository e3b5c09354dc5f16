"""Linear-operator protocol — the MatShell replacement.

The reference attaches a user context and a MATOP_MULT callback to a PETSc
shell matrix so KSP can apply a matrix-free operator (reference
src/poissbox.f90:24-69, 242-267, 300-322). In JAX an operator is just a pure
function; this module gives it enough structure for solvers and
preconditioners: the apply closure, an optional diagonal (for Jacobi/SOR
smoothers), and an optional null-space projector (the MatNullSpace analogue,
reference src/poissbox.f90:284-291).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

Array = jax.Array


def make_nullspace_projector() -> Callable[[Array], Array]:
    """Projector removing the constant null-space component: x - mean(x).

    For the fully periodic (or all-Neumann) Poisson system the operator is
    singular with a constant null space; the reference registers a constant
    MatNullSpace so PETSc projects it inside KSP (src/poissbox.f90:284-291).
    Under GSPMD the mean is a global reduction (psum across the mesh).
    """

    def project(x: Array) -> Array:
        return x - jnp.mean(x)

    # marker consumed by solvers.cg: the rank-one mean-removal form lets
    # the projection fold into the CG reductions instead of costing its
    # own memory passes; custom projectors take the generic path
    project.is_constant_projector = True
    return project


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """A matrix-free linear operator A: field -> field.

    Attributes:
      apply: y = A(x), pure and jit-compatible.
      diagonal: returns diag(A) as a field or scalar (for Jacobi-type
        smoothers / preconditioners); None if unavailable.
      nullspace: projector onto range(A) (constant-removal for singular
        periodic systems); None for nonsingular operators.
      symmetric: operator symmetry (CG requires it).
    """

    apply: Callable[[Array], Array]
    diagonal: Optional[Callable[[], Array]] = None
    nullspace: Optional[Callable[[Array], Array]] = None
    symmetric: bool = True
    # optional matvec + dot: x -> (A x, <x, A x>); the distributed
    # operator computes the dot inside its shard_map pass (psum'd partials)
    apply_dot: Optional[Callable[[Array], tuple]] = None
    # optional exact direct solve x = A^+ b (shift-invariant periodic
    # operators are FFT-diagonalizable); consumed by ksp_type="fft"
    direct_solve: Optional[Callable[[Array], Array]] = None

    def __call__(self, x: Array) -> Array:
        return self.apply(x)

    def project(self, x: Array) -> Array:
        """Apply the null-space projector if one is attached."""
        return x if self.nullspace is None else self.nullspace(x)


def aslinearoperator(fn: Callable[[Array], Array], **kw) -> LinearOperator:
    """Wrap a bare apply function (MatCreateShell analogue)."""
    return LinearOperator(apply=fn, **kw)
