"""Checkpoint/resume tests: a CG solve interrupted at k iterations and
resumed from its checkpoint must reach the same solution as an
uninterrupted solve (capability beyond the reference, which is one-shot —
SURVEY.md §5.4)."""

import jax
import jax.numpy as jnp
import numpy as np

from poissbox_tpu import checkpoint
from poissbox_tpu.mesh import Grid3D
from poissbox_tpu.ops.stencil import make_laplacian_operator
from poissbox_tpu.solvers import cg


def test_save_load_roundtrip(tmp_path):
    state = {"x": jnp.arange(12.0).reshape(3, 4),
             "iterations": jnp.int32(7)}
    p = checkpoint.save(str(tmp_path / "ckpt"), state)
    loaded = checkpoint.load(p)
    np.testing.assert_array_equal(np.asarray(loaded["x"]),
                                  np.asarray(state["x"]))
    assert int(loaded["iterations"]) == 7


def test_sharded_roundtrip(tmp_path):
    # Orbax must preserve values for sharded fields (multi-host analogue
    # exercised on the virtual mesh)
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    grid = Grid3D((16, 16, 16)).with_mesh()
    u = grid.random(jax.random.PRNGKey(5))
    p = checkpoint.save(str(tmp_path / "sharded"), {"u": u})
    loaded = checkpoint.load(p)
    np.testing.assert_array_equal(np.asarray(loaded["u"]), np.asarray(u))


def test_resume_matches_uninterrupted(tmp_path):
    grid = Grid3D((16, 16, 16))
    A = make_laplacian_operator(grid)
    key = jax.random.PRNGKey(0)
    u = A.project(jax.random.normal(key, grid.n, jnp.float64))
    b = A(u)

    full = cg(A, b, rtol=1e-10, max_it=2000)

    part = cg(A, b, rtol=1e-10, max_it=20)       # interrupted early
    st = checkpoint.SolveCheckpoint.from_result(part, b=b)
    p = checkpoint.save(str(tmp_path / "solve"), st.as_dict())
    restored = checkpoint.SolveCheckpoint.from_dict(checkpoint.load(p))
    resumed = cg(A, restored.b, x0=restored.x, rtol=1e-10, max_it=2000)

    assert bool(resumed.converged)
    np.testing.assert_allclose(np.asarray(resumed.x), np.asarray(full.x),
                               rtol=1e-6, atol=1e-8)
    # resuming saved work: fewer iterations than from scratch
    assert int(resumed.iterations) < int(full.iterations)


def _problem(n=16):
    grid = Grid3D((n, n, n))
    A = make_laplacian_operator(grid)
    u = A.project(jax.random.normal(jax.random.PRNGKey(0), grid.n,
                                    jnp.float64))
    return A, A(u)


def test_inloop_checkpoint_kill_and_resume(tmp_path):
    """Periodic in-loop snapshots — a solve
    killed mid-run resumes from the last chunk with <= `every` wasted
    iterations, and converges to the uninterrupted solution. Uses the
    solver of record (MG-CG), whose per-iteration linear convergence makes
    chunk restarts nearly free (plain CG pays its lost Krylov directions
    on restart; the 1024^3 scenario this protects is always MG-CG)."""
    from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner

    A, b = _problem(32)
    M = make_mg_preconditioner((32,) * 3, (1.0 / 32,) * 3, MGConfig(),
                               dtype=jnp.float64)
    path = str(tmp_path / "inloop")
    every = 2

    full = cg(A, b, M=M, rtol=1e-10, max_it=2000)
    it_full = int(full.iterations)
    assert it_full > 3 * every  # the problem genuinely spans chunks

    class Killed(RuntimeError):
        pass

    def kill_after(k, _res):
        if k == 1:  # die after the SECOND chunk's snapshot
            raise Killed()

    try:
        checkpoint.solve_with_checkpoints(
            A, b, path, M=M, rtol=1e-10, max_it=2000, every=every,
            on_chunk=kill_after)
        raise AssertionError("kill did not fire")
    except Killed:
        pass

    # the persisted state has exactly 2 chunks of work
    st = checkpoint.SolveCheckpoint.from_dict(checkpoint.load(path))
    assert st.iterations == 2 * every

    # resume: continues from the snapshot, not from zero
    res, total = checkpoint.solve_with_checkpoints(
        A, b, path, M=M, rtol=1e-10, max_it=2000, every=every)
    assert int(res.reason) > 0
    # wasted work bounded: at most ~1 extra iteration per chunk restart
    chunks = -(-it_full // every)
    assert total <= it_full + chunks + 1, (total, it_full)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(full.x),
                               rtol=1e-6, atol=1e-8)

    # a fresh call on the FINISHED checkpoint does no further work
    res2, total2 = checkpoint.solve_with_checkpoints(
        A, b, path, M=M, rtol=1e-10, max_it=2000, every=every)
    assert total2 == total


def test_inloop_checkpoint_ignores_foreign_rhs(tmp_path):
    """A checkpoint written for a different RHS must not warm-start."""
    A, b = _problem()
    path = str(tmp_path / "foreign")
    other = b + 1.0e-3
    checkpoint.save(path, checkpoint.SolveCheckpoint(
        x=jnp.zeros_like(b), b=other, iterations=50,
        residual_norm=1.0).as_dict())
    res, total = checkpoint.solve_with_checkpoints(
        A, b, path, rtol=1e-8, max_it=500, every=500)
    assert int(res.reason) > 0
    assert total == int(res.iterations)  # started from zero, not 50
