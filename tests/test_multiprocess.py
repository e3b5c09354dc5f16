"""Multi-process runtime smoke test — the MPI_Init analogue, really run.

The reference initializes MPI and reports size/rank on every run
(reference src/example.f90:43-53). `mesh.init_distributed` is its analogue;
this test actually exercises it across two OS processes on CPU (Gloo
collectives), asserting process count, cross-process device visibility, a
global reduction, and a sharded matvec — so the multi-host code path is no
longer untested scaffolding.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    pid, port = int(sys.argv[1]), sys.argv[2]

    from poissbox_tpu.mesh import Grid3D, init_distributed
    init_distributed(f"localhost:{port}", 2, pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.process_index() == pid

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    devs = jax.devices()           # spans both processes
    assert len(devs) == 2, devs
    assert len(jax.local_devices()) == 1

    # 3-D domain decomposition across the two processes
    n = 16
    mesh3 = Mesh(np.array(devs).reshape(2, 1, 1), ("x", "y", "z"))
    grid = Grid3D((n, n, n), mesh=mesh3)
    counts = grid.dof_counts()
    assert sum(counts) == n**3 and len(counts) == 2, counts

    from poissbox_tpu.ops.stencil import apply_laplacian, make_laplacian_operator
    A = make_laplacian_operator(grid)     # auto -> dist (shard_map + ppermute)
    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, grid.n, jnp.float64)
    got = jax.jit(A)(grid.shard(u))
    want = apply_laplacian(u, grid.deltas)
    # each process holds one shard; compare the addressable half
    for s in got.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(s.data), np.asarray(want[s.index]),
            rtol=1e-13, atol=1e-10)

    total = jax.jit(jnp.sum,
                    out_shardings=NamedSharding(mesh3, PartitionSpec()))(
        grid.shard(u))
    ref = float(jnp.sum(u))
    assert abs(float(total) - ref) < 1e-8 * (abs(ref) + 1.0)
    print(f"WORKER_OK {pid}")
""")


_SOLVE_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    pid, port, nproc = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
    pgrid = tuple(int(v) for v in sys.argv[4].split(","))

    from poissbox_tpu.mesh import Grid3D, init_distributed, make_device_mesh
    init_distributed(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc

    import jax.numpy as jnp

    # full MG-CG solve across the multi-process mesh: distributed fine
    # levels (shard_map halo exchanges between OS processes) + replicated
    # coarse tail + the level-transition reshards — the reference's
    # `mpirun -n 3` end-to-end evidence (reference README.md:25-33,
    # src/example.f90:43-84)
    n, rtol = int(sys.argv[5]), 1e-6
    mesh = make_device_mesh(pgrid)
    grid = Grid3D((n, n, n), mesh=mesh)

    from poissbox_tpu.ops.stencil import make_laplacian_operator
    from poissbox_tpu.solvers.cg import cg
    from poissbox_tpu.solvers.mg import MGConfig, make_mg_preconditioner
    A = make_laplacian_operator(grid)
    M = make_mg_preconditioner(grid.n, grid.deltas, MGConfig(),
                               dtype=jnp.float64, grid=grid)
    u = jax.random.uniform(jax.random.PRNGKey(0), grid.n, jnp.float64,
                           -1.0, 1.0)
    b = A(grid.shard(u - jnp.mean(u)))

    @jax.jit
    def step(rhs):
        res = cg(A, rhs, M=M, rtol=rtol, max_it=25)
        return res.x, res.residual_norm, res.history[0], res.reason

    x, rnorm, r0, reason = step(b)
    jax.block_until_ready(x)
    rel = float(rnorm) / max(float(r0), 1e-300)
    assert int(reason) > 0, f"no convergence across processes: {int(reason)}"
    assert rel <= rtol * 1.01, f"relative residual {rel:.3e} > rtol {rtol:g}"
    # true residual of the returned iterate, verified locally per shard
    # (the demo's final check, reference src/example.f90:79-84)
    ax = jax.jit(A)(x)
    for s_ax, s_b in zip(ax.addressable_shards, b.addressable_shards):
        np.testing.assert_allclose(np.asarray(s_ax.data),
                                   np.asarray(s_b.data),
                                   rtol=0, atol=rtol * 40 * float(r0))

    # pencil compact Laplacian across the processes: the all-to-all
    # transpose schedule actually crosses an OS-process boundary.
    # Uneven decompositions (e.g. 32^3 on 3 ranks — the reference's
    # mpirun -np 3 shape) run the padded-layout MG-CG above instead;
    # pencil transposes need divisible shards.
    if not grid.uneven:
        from poissbox_tpu.ops import compact, compact_dist
        g = jax.random.uniform(jax.random.PRNGKey(1), grid.n, jnp.float64)
        f = grid.shard(g)
        lap_d = jax.jit(lambda v: compact_dist.lapl(v, grid))(f)
        lap_s = compact.lapl(g, grid.deltas)
        for s in lap_d.addressable_shards:
            got = np.asarray(s.data)
            want = np.asarray(lap_s[s.index])
            denom = float(np.sqrt(np.mean(lap_s * lap_s))) + 1e-300
            rel_rms = float(np.sqrt(np.mean((got - want) ** 2))) / denom
            assert rel_rms <= 50 * np.finfo(np.float64).eps, rel_rms
    else:
        # uneven: verify the DoF ownership split matches the DMDA plan
        m = grid.valid_mask(jnp.float64)
        mine = sum(int(np.asarray(s.data).sum())
                   for s in m.addressable_shards)
        from poissbox_tpu.parallel.decomp import dof_distribution
        pg = tuple(mesh.shape[nm] for nm in grid.axis_names)
        assert mine in dof_distribution(grid.n, pg), (mine, pg)
    print(f"WORKER_OK {pid} iters_rel {rel:.3e}")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(sys.platform != "linux", reason="gloo CPU collectives")
def test_two_process_init_and_collectives(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__)) + (
        os.pathsep + env.get("PYTHONPATH", ""))
    # the workers manage their own backend config
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, out


@pytest.mark.slow
@pytest.mark.skipif(sys.platform != "linux", reason="gloo CPU collectives")
# NB: a (4, "2,2,1") case was tried and hangs in Gloo's 2-rank subgroup
# collectives on this CPU backend (shutdown barrier 2/4, ranks stuck in a
# sub-communicator) — a gloo-backend limitation (accelerator collectives
# have no per-subgroup TCP rendezvous).
# SINGLE-AXIS process grids avoid subgroup communicators entirely (every
# collective spans the full process set), so 3- and 4-process runs work:
# (3, "3,1,1") is the reference's canonical `mpirun -np 3` shape and runs
# the padded uneven layout across real OS-process boundaries.
@pytest.mark.parametrize("nproc,pgrid,n", [
    (2, "2,1,1", 32),
    (3, "3,1,1", 32),   # uneven (32/3): padded layout across processes
    (4, "4,1,1", 32),
])
def test_multi_process_full_mgcg_solve_and_pencil(tmp_path, nproc, pgrid, n):
    """One COMPLETE MG-CG solve (distributed fine levels, replicated coarse
    tail) and one pencil compact Laplacian across 2, 3, and 4 OS
    processes — the reference's `mpirun -n 3` end-to-end run (reference
    README.md:25-33), with the same convergence gates as
    `__graft_entry__.dryrun_multichip`."""
    worker = tmp_path / "solve_worker.py"
    worker.write_text(_SOLVE_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__)) + (
        os.pathsep + env.get("PYTHONPATH", ""))
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(port),
                          str(nproc), pgrid, str(n)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, text=True)
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, out


def test_init_distributed_noop_single_process():
    # in-process: the runtime is already (implicitly) single-process
    # initialized; zero-arg init must be a silent no-op
    from poissbox_tpu.mesh import init_distributed
    init_distributed()


def test_init_distributed_explicit_failure_raises(monkeypatch):
    # explicit cluster parameters that cannot work must NOT fail silently
    # (round-1 code swallowed every failure); auto-detection failures on a
    # plain single-process box still must
    import jax
    from jax._src import distributed as _dist
    from poissbox_tpu.mesh import init_distributed
    if _dist.global_state.client is not None:
        pytest.skip("runtime already distributed-initialized")

    def boom(*a, **k):
        raise RuntimeError("no cluster")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError):
        init_distributed("host:1", 2, 0)
    init_distributed()  # zero-arg auto-detect: swallowed, single-process
