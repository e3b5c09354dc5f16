"""Test configuration.

Runs the suite on a *virtual 8-device CPU mesh* in double precision: the
reference's whole numeric policy is double (reference src/constants.f90:15)
and its test tolerance tiers (100*eps exact identities, 1e-11 / 1e-9 RMS)
require f64. Multi-device behavior (halo exchange, sharded solves, DoF
distribution invariants) is exercised on the forced 8-CPU mesh — the
replacement for the reference's "runtime self-checks under mpirun"
methodology (reference src/example.f90:92-152).

JAX is configured here, before first backend use. With JAX_PLATFORMS unset
or "cpu" the suite runs on the virtual CPU mesh. Tests that need a GPU
carry the `gpu` marker and take the `gpu` fixture, which skips them unless
JAX's first device is a GPU; run them on a card with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import os

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at test time)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(20260816)


def feq(val, ref, tol=None) -> bool:
    """The reference's scalar equality helper: |val-ref| <= tol*|ref| or
    <= tol, tol defaulting to 100*eps (reference
    tests/coefficients/test_d2dx2.f90:194-213)."""
    if tol is None:
        tol = 100 * np.finfo(np.float64).eps
    delta = abs(float(val) - float(ref))
    return (delta <= tol * abs(float(ref))) or (delta <= tol)


def rms(x) -> float:
    x = np.asarray(x)
    return float(np.sqrt(np.mean(x**2)))
