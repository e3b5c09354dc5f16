"""Non-divisible (uneven) decomposition tests — pad-and-mask execution.

The reference's canonical parallel demo is 64^3 on 3 MPI ranks with the
90112/86016/86016 DoF split (reference README.md:25-33); PETSc's DMDA
handles any rank count via PETSC_DECIDE (reference src/poissbox.f90:191-200).
These tests verify the equivalent here (`parallel.uneven` padded
layout) end-to-end on the virtual CPU mesh: execution ownership matches the
DMDA split, the masked operators match the unsharded ones exactly, and the
full MG-CG solve converges with the same iteration count as unsharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.mesh import Grid3D, make_device_mesh
from poissbox_tpu.ops.stencil import apply_laplacian, make_laplacian_operator
from poissbox_tpu.parallel import uneven as ue
from poissbox_tpu.solvers.cg import cg
from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner

UNEVEN_PGRIDS = [(3, 1, 1), (5, 1, 1), (3, 2, 1), (7, 1, 1)]


def make_grid(n=(64, 64, 64), pgrid=(3, 1, 1)):
    need = int(np.prod(pgrid))
    if len(jax.devices()) < need:
        pytest.skip(f"needs {need} devices")
    mesh = make_device_mesh(pgrid, devices=jax.devices()[:need])
    return Grid3D(tuple(n), mesh=mesh)


def rand_field(grid, seed=0, dtype=jnp.float64):
    return jax.random.uniform(jax.random.PRNGKey(seed), grid.n, dtype, -1, 1)


# ---------------------------------------------------------------------------
# layout + ownership
# ---------------------------------------------------------------------------

def test_reference_dof_split_executes():
    """64^3 on 3 devices: the reference README's split, actually executed."""
    grid = make_grid((64, 64, 64), (3, 1, 1))
    assert grid.uneven
    assert grid.dof_counts() == [90112, 86016, 86016]
    assert grid.padded_n == (66, 64, 64)
    f = grid.shard(rand_field(grid))
    # each device holds exactly one (22, 64, 64) padded block
    shapes = sorted(s.data.shape for s in f.addressable_shards)
    assert shapes == [(22, 64, 64)] * 3
    # valid cells per device match the DMDA ownership report
    m = grid.valid_mask(jnp.float64)
    per_dev = sorted(
        (int(s.data.sum()) for s in m.addressable_shards), reverse=True)
    assert per_dev == [90112, 86016, 86016]


@pytest.mark.parametrize("pgrid", UNEVEN_PGRIDS)
def test_roundtrip_and_pads_zero(pgrid):
    grid = make_grid((64, 64, 64), pgrid)
    u = rand_field(grid)
    up = grid.shard(u)
    assert tuple(up.shape) == grid.padded_n
    # pads are zero and the roundtrip is exact
    m = ue.valid_mask(grid, u.dtype)
    assert float(jnp.max(jnp.abs(up * (1 - m)))) == 0.0
    np.testing.assert_array_equal(np.asarray(grid.unshard(up)), np.asarray(u))


def test_shift_padded_matches_roll():
    grid = make_grid((64, 64, 64), (3, 2, 1))
    u = rand_field(grid, seed=3)
    up = grid.shard(u)
    m = ue.valid_mask(grid, u.dtype)
    for ax in range(3):
        for s in (1, -1):
            got = ue.shift_padded(up, ax, s, grid) * m
            want = grid.shard(jnp.roll(u, -s, ax))
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       atol=0)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pgrid", UNEVEN_PGRIDS)
def test_matvec_matches_unsharded(pgrid):
    """Sharded uneven matvec == serial operator, exactly (same FP ops)."""
    grid = make_grid((64, 64, 64), pgrid)
    u = rand_field(grid, seed=1)
    A = make_laplacian_operator(grid)
    out = jax.jit(A)(grid.shard(u))
    ref = apply_laplacian(u, grid.deltas)
    np.testing.assert_array_equal(np.asarray(grid.unshard(out)),
                                  np.asarray(ref))
    # operator output keeps pads identically zero
    m = ue.valid_mask(grid, u.dtype)
    assert float(jnp.max(jnp.abs(out * (1 - m)))) == 0.0


def test_masked_projector():
    grid = make_grid((64, 64, 64), (3, 1, 1))
    A = make_laplacian_operator(grid)
    up = grid.shard(rand_field(grid, seed=2) + 0.7)
    z = A.project(up)
    m = ue.valid_mask(grid, up.dtype)
    # mean over VALID cells removed; pads untouched (zero)
    assert abs(float(jnp.sum(z))) < 1e-10 * grid.ndof
    assert float(jnp.max(jnp.abs(z * (1 - m)))) == 0.0
    # idempotent
    np.testing.assert_allclose(np.asarray(A.project(z)), np.asarray(z),
                               atol=1e-14)


def test_sweeps_match_serial():
    """Jacobi and red-black SOR sweeps == their serial formulations."""
    grid = make_grid((64, 64, 64), (3, 2, 1))
    deltas = grid.deltas
    invs = [1.0 / d**2 for d in deltas]
    diag = -2.0 * sum(invs)
    x = rand_field(grid, seed=4)
    b = rand_field(grid, seed=5)
    xp, bp = grid.shard(x), grid.shard(b)

    got = grid.unshard(ue.jacobi_sweep_uneven(xp, bp, grid, 0.9))
    want = x + (0.9 / diag) * (b - apply_laplacian(x, deltas))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-14)

    ii, jj, kk = np.meshgrid(*(np.arange(64),) * 3, indexing="ij")
    for color in (0, 1):
        got = grid.unshard(ue.sor_sweep_uneven(xp, bp, grid, 1.0, color))
        mask = jnp.asarray(((ii + jj + kk) % 2 == color), x.dtype)
        want = x + (1.0 / diag) * mask * (b - apply_laplacian(x, deltas))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-14)


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def _solve_pair(grid, rtol=1e-8, smoother="sor"):
    """(uneven sharded solve, unsharded solve) of the same 64^3 problem."""
    u = rand_field(grid, seed=0)
    u = u - jnp.mean(u)
    A = make_laplacian_operator(grid)
    cfg = MGConfig(smoother=smoother)
    M = make_mg_preconditioner(grid.n, grid.deltas, cfg, dtype=jnp.float64,
                               grid=grid)
    b = A(grid.shard(u))
    res = jax.jit(lambda bb: cg(A, bb, M=M, rtol=rtol, max_it=30))(b)

    gs = Grid3D(grid.n)
    As = make_laplacian_operator(gs)
    Ms = make_mg_preconditioner(gs.n, gs.deltas, cfg, dtype=jnp.float64)
    rs = jax.jit(lambda bb: cg(As, bb, M=Ms, rtol=rtol, max_it=30))(As(u))
    return res, rs, grid.unshard(res.x)


@pytest.mark.parametrize("pgrid", [(3, 1, 1), (3, 2, 1)])
def test_mgcg_converges_and_matches_unsharded(pgrid):
    """The reference demo's solve (64^3, CG + MG) on a non-divisible mesh:
    converged, same iteration count as unsharded, same solution."""
    grid = make_grid((64, 64, 64), pgrid)
    res, rs, x_l = _solve_pair(grid)
    assert int(res.reason) > 0
    assert int(res.iterations) == int(rs.iterations)
    rel = float(res.residual_norm) / float(res.history[0])
    assert rel <= 1e-8
    np.testing.assert_allclose(np.asarray(x_l), np.asarray(rs.x), atol=1e-12)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_mgcg_other_smoothers(smoother):
    grid = make_grid((64, 64, 64), (3, 1, 1))
    res, rs, x_l = _solve_pair(grid, smoother=smoother)
    assert int(res.reason) > 0
    assert int(res.iterations) == int(rs.iterations)
    np.testing.assert_allclose(np.asarray(x_l), np.asarray(rs.x), atol=1e-12)


def test_plain_cg_uneven():
    """Unpreconditioned CG (explicit projector path) on a small uneven grid."""
    grid = make_grid((24, 24, 24), (5, 1, 1))
    u = rand_field(grid, seed=6)
    u = u - jnp.mean(u)
    A = make_laplacian_operator(grid)
    b = A(grid.shard(u))
    res = jax.jit(lambda bb: cg(A, bb, rtol=1e-8, max_it=400))(b)
    assert int(res.reason) > 0
    x_l = grid.unshard(res.x)
    r = apply_laplacian(x_l, grid.deltas) - grid.unshard(b)
    rel = float(jnp.linalg.norm(r.ravel())) / float(
        jnp.linalg.norm(np.asarray(grid.unshard(b)).ravel()))
    assert rel <= 1.1e-8


def test_fft_direct_solve_uneven():
    """`-ksp_type fft` on a non-divisible mesh: gather-solve-scatter
    fallback (pencil transposes need divisible shards) — exact result,
    padded layout preserved."""
    grid = make_grid((32, 32, 32), (3, 1, 1))
    from poissbox_tpu.solvers.fft import poisson_solve_fft, poisson_solve_fft_dist
    u = rand_field(grid, seed=8)
    u = u - jnp.mean(u)
    A = make_laplacian_operator(grid)
    b = A(grid.shard(u))
    x = jax.jit(lambda bb: poisson_solve_fft_dist(bb, grid))(b)
    assert tuple(x.shape) == grid.padded_n
    want = poisson_solve_fft(apply_laplacian(u, grid.deltas), grid.deltas)
    np.testing.assert_allclose(np.asarray(grid.unshard(x)),
                               np.asarray(want), atol=1e-10)
    m = ue.valid_mask(grid, x.dtype)
    assert float(jnp.max(jnp.abs(x * (1 - m)))) == 0.0


def test_compact_dist_uneven_fallback():
    """compact_dist operators on a non-divisible mesh: gather-solve-scatter
    (pencil transposes need divisible shards) — results equal the serial
    operators, padded layout preserved."""
    from poissbox_tpu.ops import compact, compact_dist
    grid = make_grid((24, 24, 24), (3, 1, 1))
    f = rand_field(grid, seed=9)
    fp = grid.shard(f)
    lap = jax.jit(lambda v: compact_dist.lapl(v, grid))(fp)
    np.testing.assert_allclose(np.asarray(grid.unshard(lap)),
                               np.asarray(compact.lapl(f, grid.deltas)),
                               atol=1e-10)
    g = jax.jit(lambda v: compact_dist.grad(v, grid))(fp)
    want = compact.grad(f, grid.deltas)
    for i in range(3):
        np.testing.assert_allclose(np.asarray(grid.unshard(g[..., i])),
                                   np.asarray(want[..., i]), atol=1e-10)
    dv = jax.jit(lambda v: compact_dist.div(v, grid))(g)
    np.testing.assert_allclose(np.asarray(grid.unshard(dv)),
                               np.asarray(compact.div(want, grid.deltas)),
                               atol=1e-10)


def test_pipecg_uneven():
    grid = make_grid((64, 64, 64), (3, 1, 1))
    from poissbox_tpu.solvers.pipecg import pipecg
    u = rand_field(grid, seed=7)
    u = u - jnp.mean(u)
    A = make_laplacian_operator(grid)
    M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(),
                               dtype=jnp.float64, grid=grid)
    b = A(grid.shard(u))
    res = jax.jit(lambda bb: pipecg(A, bb, M=M, rtol=1e-8, max_it=30))(b)
    assert int(res.reason) > 0
    rel = float(res.residual_norm) / float(res.history[0])
    assert rel <= 1e-8
