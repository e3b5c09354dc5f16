"""Precision policy.

The reference pins a single working precision for the whole stack
(`pb_dp = kind(0.0d0)` — double precision, chosen to match the linked PETSc
build; reference src/constants.f90:9-17). The analogue here is a
*default real dtype* that follows JAX's x64 switch: float64 when x64 is
enabled (the reference's precision of record), float32 otherwise (the
fast path). All kernels are dtype-polymorphic; this module
only supplies the default used when creating fields from scratch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def enable_x64() -> None:
    """Switch JAX to 64-bit mode. Must run before the first JAX operation."""
    jax.config.update("jax_enable_x64", True)


def default_real() -> jnp.dtype:
    """The framework's default real dtype (pb_dp analogue)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def epsilon(dtype=None) -> float:
    """Machine epsilon for `dtype` (defaults to the current default real)."""
    return float(jnp.finfo(dtype or default_real()).eps)

