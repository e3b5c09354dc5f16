"""Profiling — the `-log_view` analogue.

`trace` wraps `jax.profiler.trace` for TensorBoard/Perfetto-viewable device
traces; `kernel_time` gives the steady-state wall time of one jitted call:
compile and warm once, then the best of `reps` timings on the host clock
around `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    with jax.profiler.trace(logdir):
        yield logdir


def kernel_time(fn: Callable, *args, k: int = 1, reps: int = 3) -> float:
    """Steady-state seconds per call of `fn(*args)`, jitted. Each timing
    enqueues `k` calls and blocks once on the last (k > 1 hides the host
    dispatch of sub-millisecond calls)."""
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(k):
            out = f(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / k)
    return best


def bandwidth_gbps(fn: Callable, example, passes: int = 2, **kw) -> float:
    """Effective memory bandwidth assuming `passes` full-array passes per
    application (2 = read + write for a perfectly fused kernel)."""
    t = kernel_time(fn, example, **kw)
    return passes * example.size * example.dtype.itemsize / t / 1e9
