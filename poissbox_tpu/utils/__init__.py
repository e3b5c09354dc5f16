"""Auxiliary subsystems: profiling, logging, runtime checking.

The reference delegates observability to PETSc flags (`-log_view`,
`-ksp_monitor`, reference README.md:48-49) and runtime safety to compiler
strictness (`-fcheck=all -ffpe-trap=...`, reference CMakeLists.txt:17).
The equivalents here: JAX profiler traces + a steady-state wall-clock
timer (utils.profiling), process-0 structured logging (utils.logging),
NaN/shape/finiteness checking (utils.debugging), and the persistent
compilation-cache location (utils.compile_cache).
"""

from poissbox_tpu.utils.profiling import kernel_time, trace
from poissbox_tpu.utils.logging import log0, is_process0
from poissbox_tpu.utils.debugging import enable_nan_checks, check_field

__all__ = ["kernel_time", "trace", "log0", "is_process0",
           "enable_nan_checks", "check_field"]
