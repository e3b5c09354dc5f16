"""Process-0 structured logging.

The reference prints from every rank (`print *` on all ranks, reference
src/example.f90:53,114); in a multi-host job that floods stdout
N-processes-fold. Here reporting is process-0-only by default, with the
residual-monitor formatting of `-ksp_monitor` handled by
SolveResult.monitor_lines (solvers.result).
"""

from __future__ import annotations

import sys

import jax


def is_process0() -> bool:
    return jax.process_index() == 0


def log0(*args, file=None, all_processes: bool = False, **kw) -> None:
    """Print from process 0 (or everywhere with all_processes=True,
    prefixed by process index the way the reference prefixes ranks)."""
    if all_processes:
        print(f"[p{jax.process_index()}]", *args, file=file or sys.stdout, **kw)
    elif is_process0():
        print(*args, file=file or sys.stdout, **kw)
