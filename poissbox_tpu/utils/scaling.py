"""Multi-chip scaling model — census-grounded, machine-checkable.

The reference's scaling story is MPI domain decomposition with width-1 halo
exchanges (reference src/poissbox.f90:104-105, README.md:25-33). Two
pieces hold it to account:

  1. an ANALYTIC replay of every collective the distributed MG-CG
     iteration issues — counts and per-device byte volumes, level by
     level (:func:`mgcg_iteration_model`), asserted against the census of
     the compiled while body on a virtual CPU mesh
     (tests/test_scaling_model.py::test_scaling_model_matches_census);
  2. a prediction pipeline (:func:`predict_efficiency`) that turns those
     byte volumes, a per-iteration compute time and a link bandwidth —
     both supplied by the caller — into weak/strong-scaling efficiencies.

Byte volumes are per-device (SPMD): every device sends/receives the same
face planes, so per-device bytes / per-link bandwidth is the wire time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Per-iteration collective volumes of the distributed MG-CG solve."""

    permute_count: int        # collective-permutes in one CG iteration
    permute_bytes: int        # their per-device payload sum, bytes
    gather_bytes: int         # coarse-transition all-gather payload, bytes
    axis_bytes: tuple         # permute bytes split by array dim (wire time
    #                           is per-axis: different mesh axes = links)
    levels: tuple             # (shape, distributed) per MG level


def _local(n, pgrid):
    return tuple(nn // p for nn, p in zip(n, pgrid))


def _sharded_dims(pgrid) -> list[int]:
    return [d for d, p in enumerate(pgrid) if p > 1]


def _face_bytes(loc, d: int, itemsize: int) -> int:
    b = itemsize
    for i, nn in enumerate(loc):
        if i != d:
            b *= nn
    return b


def mgcg_iteration_model(n: Sequence[int], pgrid: Sequence[int],
                         cfg=None, itemsize: int = 4) -> CommModel:
    """Replay the collectives of ONE distributed MG-CG iteration.

    Mirrors solvers.mg's level construction (`_build_levels` /
    `_level_shardable`) and cycle structure plus solvers.cg's matvec: each
    halo exchange is 2 collective-permutes per sharded dim (one face plane
    each, parallel.dist_stencil._halo_diffs); the roll-form transfers on
    distributed levels move one face plane per sharded dim per roll; the
    first replicated level costs one all-gather per visit.
    """
    from poissbox_tpu.solvers import mg as mgm

    cfg = mgm._resolve_sweeps(cfg or mgm.MGConfig(), n)
    pre, post = cfg.pre_smooth, cfg.post_smooth

    # level stack, mirroring _build_levels + _level_shardable
    levels = []
    cur = tuple(n)
    while True:
        dist = all(cur[d] % p == 0 and (cur[d] // p) % 2 == 0
                   for d, p in enumerate(pgrid) if p > 1)
        levels.append((cur, dist))
        if min(cur) <= cfg.coarse_size or any(x % 2 for x in cur):
            break
        cur = tuple(x // 2 for x in cur)

    count = 0
    ab = [0, 0, 0]   # permute bytes by array dim
    gather = 0

    def exchange(loc, times: int = 1):
        nonlocal count
        for d in _sharded_dims(pgrid):
            count += 2 * times
            ab[d] += 2 * times * _face_bytes(loc, d, itemsize)

    def visits(idx: int) -> int:
        """Visit count of level idx per top-level cycle (W doubles the
        sub-fine levels down to w_depth; V visits each once)."""
        if cfg.cycle != "w" or idx == 0:
            return 1
        return 2 ** min(idx, cfg.w_depth + 1, len(levels) - 1)

    # CG body: one fused matvec+dot halo exchange on the fine grid
    exchange(_local(n, pgrid))

    for idx, (shape, dist) in enumerate(levels[:-1]):
        if not dist:
            break  # replicated from here down: no collectives below
        v = visits(idx)
        loc = _local(shape, pgrid)
        # smoothing: zero-guess pre = 2*pre - 1 color updates (first color
        # closed-form, no exchange), post = 2*post; W-cycle second visits
        # re-enter through v_cycle (zero guess again) plus one extra
        # residual exchange at this level (the e-correction form)
        sweeps_ex = (2 * pre - 1) + 2 * post
        exchange(loc, v * sweeps_ex)
        # residual before restriction: one exchange per visit (the model is
        # exact for V-cycles, the default; W adds a correction matvec at
        # each revisited CHILD level that this visit count approximates)
        exchange(loc, v)
        # transfers (roll form on distributed levels): restrict rolls the
        # pair-split array +-1 per dim (2 permutes per sharded dim, face of
        # the progressively-halved array)
        c = list(loc)
        for ax in range(3):
            if pgrid[ax] > 1:
                count += 2 * v
                ab[ax] += 2 * v * _face_bytes(c, ax, itemsize)
            c[ax] //= 2
        nxt_dist = levels[idx + 1][1]
        if nxt_dist:
            # prolongation rolls on the coarse array doubling back up
            c = list(_local(levels[idx + 1][0], pgrid))
            for ax in range(3):
                if pgrid[ax] > 1:
                    count += 2 * v
                    ab[ax] += 2 * v * _face_bytes(c, ax, itemsize)
                c[ax] *= 2
        else:
            # level transition to the replicated tail: one all-gather of
            # the coarse field per visit
            gather += v * itemsize * math.prod(levels[idx + 1][0])

    return CommModel(permute_count=count, permute_bytes=sum(ab),
                     gather_bytes=gather, axis_bytes=tuple(ab),
                     levels=tuple(levels))


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Weak/strong-scaling prediction for one configuration."""

    n: tuple
    pgrid: tuple
    compute_s: float          # per-iteration compute at this local size
    comm_s: float             # per-iteration wire time (max over axes)
    gather_s: float
    efficiency_overlapped: float   # halos hidden behind bulk kernels
    efficiency_serial: float       # no overlap (lower bound)


def predict_efficiency(n: Sequence[int], pgrid: Sequence[int],
                       compute_s_per_it: float, link_bw: float,
                       cfg=None, itemsize: int = 4,
                       model: Optional[CommModel] = None) -> Prediction:
    """Efficiency of one MG-CG iteration at global size `n` over `pgrid`.

    `compute_s_per_it` is the per-iteration compute for the LOCAL block
    size (weak scaling: the single-device time at n_local; strong scaling:
    the single-device time scaled by the block ratio). `link_bw` is the
    one-way bandwidth, bytes/s, that each mesh axis's halo traffic gets.
    Wire time is the MAX over axes, each axis_bytes / link_bw. The
    overlapped number assumes the permutes hide behind the bulk compute;
    the serial one is the floor.
    """
    m = model or mgcg_iteration_model(n, pgrid, cfg, itemsize)
    bw = float(link_bw)
    comm = max(m.axis_bytes) / bw if any(m.axis_bytes) else 0.0
    # the replicated-tail gather crosses the mesh once per iteration and
    # cannot overlap the level transition it feeds
    gather = m.gather_bytes / bw
    t_overlap = max(compute_s_per_it, comm) + gather
    t_serial = compute_s_per_it + comm + gather
    return Prediction(
        n=tuple(n), pgrid=tuple(pgrid), compute_s=compute_s_per_it,
        comm_s=comm, gather_s=gather,
        efficiency_overlapped=compute_s_per_it / t_overlap,
        efficiency_serial=compute_s_per_it / t_serial)
