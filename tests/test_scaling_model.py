"""The scaling model is machine-checked: the analytic collective replay of
one MG-CG iteration (utils.scaling.mgcg_iteration_model) must match the
census of the actually-compiled while body on the virtual 8-device mesh —
then its efficiency arithmetic is exercised with stated inputs (an assumed
per-iteration time and link bandwidth; neither is a measurement).

Reference anchor: the width-1 halo traffic contract of DMDA
(reference src/poissbox.f90:104-105) and the `mpirun -n 3` scaling story
(reference README.md:25-33).
"""

import jax
import jax.numpy as jnp
import pytest

from poissbox_tpu.utils.scaling import (
    mgcg_iteration_model,
    predict_efficiency,
)

# Stated inputs for the prediction arithmetic (not measurements): a
# per-iteration time of a 512^3 MG-CG iteration on one device, and a
# one-way link bandwidth of 450 GB/s (NVLink 4 per direction, NVIDIA's
# H100 SXM data sheet).
T_IT_512 = 20e-3
LINK_BW = 450e9

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device test mesh")


def _body_census(n, pgrid):
    from poissbox_tpu.config import SolverOptions
    from poissbox_tpu.mesh import Grid3D, make_device_mesh
    from poissbox_tpu.ops.stencil import make_laplacian_operator
    from poissbox_tpu.solvers.ksp import make_solver
    from poissbox_tpu.utils.census import census, while_bodies

    mesh = make_device_mesh(pgrid)
    gm = Grid3D((n, n, n)).with_mesh(mesh=mesh)
    A = make_laplacian_operator(gm)
    opts = SolverOptions(ksp_type="cg", pc_type="mg", ksp_rtol=1e-6,
                         ksp_max_it=20)
    solve = make_solver(A, opts, grid=gm, dtype=jnp.float32)
    spec = jax.ShapeDtypeStruct(
        (n, n, n), jnp.float32,
        sharding=jax.sharding.NamedSharding(gm.mesh, gm.spec))
    hlo = jax.jit(lambda b: solve(b).x).lower(spec).compile().as_text()
    for body in while_bodies(hlo):
        c = census(hlo, computation=body)
        if c.get("collective-permute"):
            return c
    raise AssertionError("no while body with permutes found")


@pytest.mark.slow
@pytest.mark.parametrize("pgrid", [(4, 2, 1), (2, 2, 2)])
def test_scaling_model_matches_census(pgrid):
    """Analytic per-iteration permute count/bytes == compiled reality.

    Tolerance: the model is exact on the halo exchanges and roll
    transfers; XLA adds a handful of plane-sized permutes around the
    replicated-tail transition (observed: +4 permutes / +128 B of 454 KB
    on (4,2,1)), so the gate is 3% bytes / 8 permutes — tight enough that
    an accidental extra exchange per level (the smallest real regression,
    ~+10% bytes) trips it.
    """
    n = 64
    got = _body_census(n, pgrid)["collective-permute"]
    want = mgcg_iteration_model((n, n, n), pgrid)
    assert abs(got["count"] - want.permute_count) <= 8, (got, want)
    assert abs(got["bytes"] - want.permute_bytes) <= 0.03 * want.permute_bytes, (
        got, want)


def test_model_scales_with_grid():
    from poissbox_tpu.solvers.mg import MGConfig

    cfg = MGConfig(pre_smooth=1, post_smooth=1)  # pin the cycle: the auto
    # sweep counts are size-aware and would confound the scaling contract
    # doubling the grid at fixed pgrid quadruples face bytes (weak-scaling
    # invariance of the per-device halo volume is over LOCAL size, which
    # this doubles)
    a = mgcg_iteration_model((64, 64, 64), (2, 2, 2), cfg)
    b = mgcg_iteration_model((128, 128, 128), (2, 2, 2), cfg)
    assert b.permute_bytes > 3.5 * a.permute_bytes
    # fixed local size: per-device fine-level face bytes identical on a
    # bigger mesh (the weak-scaling contract); the deeper hierarchy adds
    # only small coarse-level faces
    w1 = mgcg_iteration_model((128, 128, 128), (2, 2, 2), cfg)
    w2 = mgcg_iteration_model((256, 256, 256), (4, 4, 4), cfg)
    assert w2.axis_bytes[0] == pytest.approx(w1.axis_bytes[0], rel=0.25)


def test_weak_scaling_prediction_512_per_chip():
    """Weak-scaling rungs at 512^3 per device on 8 and 64 devices: with the
    stated inputs the >=80% target holds in BOTH the overlapped and the
    no-overlap accounting."""
    for pgrid in [(2, 2, 2), (4, 4, 4)]:
        n = tuple(512 * p for p in pgrid)
        pred = predict_efficiency(n, pgrid, T_IT_512, LINK_BW)
        assert pred.comm_s < 1e-3, pred          # ~MB faces over 450 GB/s
        assert pred.efficiency_overlapped >= 0.95, pred
        assert pred.efficiency_serial >= 0.80, pred


def test_strong_scaling_prediction_512_over_8():
    # strong: 512^3 split over 8 devices; compute scales by the block ratio
    pred = predict_efficiency((512, 512, 512), (2, 2, 2), T_IT_512 / 8,
                              LINK_BW)
    assert pred.efficiency_overlapped >= 0.85, pred


@pytest.mark.parametrize("link_bw", [45e9, 450e9, 900e9])
def test_prediction_arithmetic(link_bw):
    """comm_s is the largest per-axis byte volume over the link bandwidth;
    the efficiencies follow from it exactly."""
    n, pgrid = (256, 256, 256), (2, 2, 1)
    m = mgcg_iteration_model(n, pgrid)
    t = 5e-3
    pred = predict_efficiency(n, pgrid, t, link_bw, model=m)
    assert pred.comm_s == pytest.approx(max(m.axis_bytes) / link_bw)
    assert pred.gather_s == pytest.approx(m.gather_bytes / link_bw)
    assert pred.efficiency_serial == pytest.approx(
        t / (t + pred.comm_s + pred.gather_s))
    assert pred.efficiency_overlapped == pytest.approx(
        t / (max(t, pred.comm_s) + pred.gather_s))
