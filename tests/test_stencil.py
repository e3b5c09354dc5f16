"""The 7-point operator's formulations agree: the roll form (the operator
every solver uses), the 27-point box contraction and the assembled
StencilMatrix, against a float64 numpy evaluation, on cubic, non-cubic and
non-power-of-two grids in float32 and float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.mesh import Grid3D
from poissbox_tpu.ops.assemble import assemble_laplacian
from poissbox_tpu.ops.stencil import default_impl, make_laplacian_operator

SHAPES = [(8, 8, 8), (6, 10, 12), (5, 7, 9), (16, 4, 8)]


def _numpy_lapl(u, deltas):
    u = np.asarray(u, np.float64)
    out = np.zeros_like(u)
    for ax, d in enumerate(deltas):
        out += (np.roll(u, 1, ax) - 2.0 * u + np.roll(u, -1, ax)) / d**2
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_formulations_agree(shape, dtype):
    grid = Grid3D(shape, (1.0, 1.3, 0.7))
    u = grid.random(jax.random.PRNGKey(sum(shape)), dtype)
    want = _numpy_lapl(u, grid.deltas)
    # rounding: each point sums 7 terms of size ~|u|/h^2
    tol = 32 * float(jnp.finfo(dtype).eps) * np.max(np.abs(want))
    views = {"roll": make_laplacian_operator(grid, impl="roll"),
             "pointwise": make_laplacian_operator(grid, impl="pointwise"),
             "assembled": assemble_laplacian(shape, grid.deltas, dtype)}
    for name, op in views.items():
        got = op(u)
        assert got.dtype == dtype and got.shape == shape, name
        assert np.max(np.abs(np.asarray(got, np.float64) - want)) <= tol, name


def test_default_impl_is_roll_without_mesh():
    assert default_impl() == "roll"
    assert default_impl(None) == "roll"
