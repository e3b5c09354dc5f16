"""Structured-grid management over a device mesh — the DMDA replacement.

The reference creates a periodic 3-D DMDA and lets PETSc pick the process
decomposition and each rank's owned box (`DMDACreate3d` with PETSC_DECIDE,
reference src/poissbox.f90:183-204). Here a :class:`Grid3D` couples the
global structured grid (shape, extents, spacing, periodicity) to a
`jax.sharding.Mesh`: fields are global `jnp` arrays carrying a
`NamedSharding`, XLA owns the box per device, and the decomposition choice
(`parallel.decomp.decompose_3d`) plays PETSC_DECIDE.

Axis convention: array dims are (x, y, z) with z innermost (contiguous),
so keep it unsharded where possible (the decomposition heuristic prefers
splitting x, then y).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec

from poissbox_tpu.parallel.decomp import decompose_3d, dof_distribution


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the multi-host runtime — the MPI_Init analogue
    (reference src/example.f90:43-44).

    On single-process runs this is a no-op; on multi-host jobs it wires
    `jax.distributed` (auto-detecting cluster parameters where the
    platform provides them, when no arguments are given) so
    `jax.devices()` spans all hosts.
    """
    # NB: do not touch jax.process_count()/jax.devices() here — that would
    # initialize the single-process backend and make distributed init
    # impossible ("must be called before any JAX computations").
    try:  # private, may move across JAX versions — fall back gracefully
        from jax._src import distributed as _dist
        if _dist.global_state.client is not None:
            return  # already initialized
    except (ImportError, AttributeError):
        pass  # detection unavailable: rely on initialize()'s own error
    explicit = coordinator_address is not None
    try:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
    except (ValueError, RuntimeError):
        if explicit:
            raise  # explicit cluster parameters must not fail silently
        # zero-arg auto-detection legitimately fails on plain single-process
        # environments (no cluster env vars) — run single-process


def make_device_mesh(
    pgrid: Sequence[int],
    axis_names: Sequence[str] = ("x", "y", "z"),
    devices: Optional[Sequence[jax.Device]] = None,
    auto: bool = True,
) -> Mesh:
    """Create a device mesh with GSPMD-automatic axis types.

    `auto=True` (default) marks every axis `AxisType.Auto` so plain jnp code
    on sharded arrays is auto-partitioned; explicit shard_map paths work on
    the same mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    need = int(np.prod(pgrid))
    if need > len(devices):
        raise ValueError(f"process grid {tuple(pgrid)} needs {need} devices, have {len(devices)}")
    dev_array = np.array(devices[:need]).reshape(tuple(pgrid))
    types = (AxisType.Auto,) * len(pgrid) if auto else None
    return Mesh(dev_array, tuple(axis_names), axis_types=types)


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A periodic, uniform, cell-centered 3-D structured grid.

    The reference demo hardcodes 64^3 on the unit cube with dx = 1/64
    (reference src/example.f90:24-35); here shape and extent are runtime
    parameters. Scalar fields live at cell centers x_i = (i + 1/2) dx;
    the staggered compact schemes also address vertices x_i = i dx
    (convention of reference tests/grad/test_grad_1d.f90:89-107).
    """

    n: tuple[int, int, int]
    length: tuple[float, float, float] = (1.0, 1.0, 1.0)
    mesh: Optional[Mesh] = None
    axis_names: tuple[str, str, str] = ("x", "y", "z")

    # -- geometry ----------------------------------------------------------
    @property
    def deltas(self) -> tuple[float, float, float]:
        return tuple(L / n for L, n in zip(self.length, self.n))

    @property
    def ndof(self) -> int:
        return int(np.prod(self.n))

    def cells(self, dim: int) -> jax.Array:
        """Cell-center coordinates along `dim`: (i + 1/2) * d."""
        d = self.deltas[dim]
        return (jnp.arange(self.n[dim]) + 0.5) * d

    def vertices(self, dim: int) -> jax.Array:
        """Vertex coordinates along `dim`: i * d."""
        return jnp.arange(self.n[dim]) * self.deltas[dim]

    def coords(self, staggered: tuple[bool, bool, bool] = (False, False, False)):
        """Meshgrid (X, Y, Z) of cell-center (or vertex, where staggered) coords."""
        axes = [
            self.vertices(d) if staggered[d] else self.cells(d) for d in range(3)
        ]
        return jnp.meshgrid(*axes, indexing="ij")

    # -- distribution ------------------------------------------------------
    @property
    def pgrid(self) -> tuple[int, int, int]:
        """Device counts per grid axis (1,1,1 when unmeshed)."""
        if self.mesh is None:
            return (1, 1, 1)
        return tuple(self.mesh.shape[name] for name in self.axis_names)

    @property
    def uneven(self) -> bool:
        """True when some sharded axis does not divide evenly — fields then
        use the padded layout of `parallel.uneven` (PETSc's DMDA handles
        any rank count, reference src/poissbox.f90:191-200; this is the
        equivalent here)."""
        return any(nd % p for nd, p in zip(self.n, self.pgrid))

    @property
    def padded_n(self) -> tuple[int, int, int]:
        """Stored field shape: `p * ceil(n/p)` per sharded axis (= n when
        the decomposition divides)."""
        if not self.uneven:
            return tuple(self.n)
        from poissbox_tpu.parallel.uneven import padded_shape
        return padded_shape(self.n, self.pgrid)

    def valid_mask(self, dtype=None) -> jax.Array:
        """0/1 mask of the padded shape marking owned (valid) cells."""
        from poissbox_tpu.constants import default_real
        from poissbox_tpu.parallel.uneven import valid_mask
        return self.shard(valid_mask(self, dtype or default_real()))

    def unshard(self, f: jax.Array) -> jax.Array:
        """Gather a (possibly padded) field back to the logical shape —
        the inverse of :meth:`shard` for user-facing output."""
        if self.uneven and tuple(f.shape) == self.padded_n:
            from poissbox_tpu.parallel.uneven import from_padded
            return from_padded(f, self)
        return f

    def with_mesh(self, mesh: Optional[Mesh] = None,
                  devices: Optional[Sequence[jax.Device]] = None) -> "Grid3D":
        """Attach a device mesh; if none given, decompose over all devices
        (the PETSC_DECIDE moment, reference src/poissbox.f90:191-200)."""
        if mesh is None:
            devices = list(devices if devices is not None else jax.devices())
            pgrid = decompose_3d(len(devices), self.n)
            mesh = make_device_mesh(pgrid, self.axis_names, devices)
        return dataclasses.replace(self, mesh=mesh)

    @property
    def spec(self) -> PartitionSpec:
        if self.mesh is None:
            return PartitionSpec()
        return PartitionSpec(*(
            name if self.mesh.shape[name] > 1 else None for name in self.axis_names
        ))

    @property
    def sharding(self) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec)

    def shard(self, f: jax.Array) -> jax.Array:
        """Place a global field according to the grid's sharding.

        On an uneven decomposition a logical-(nx,ny,nz) field is first
        scattered into the padded layout (pads zero) so every device holds
        exactly its owned box plus padding — execution ownership matches
        `dof_counts()` (the reference's 90112/86016/86016 on 3 ranks,
        reference README.md:25-33)."""
        if self.mesh is None:
            return f
        if self.uneven and tuple(f.shape) == tuple(self.n):
            from poissbox_tpu.parallel.uneven import to_padded
            f = to_padded(f, self)
        return jax.device_put(f, self.sharding)

    def dof_counts(self) -> list[int]:
        """Per-device DoF counts — the reference README's rank report
        (90112/86016/86016 for 64^3 on 3 ranks, reference README.md:25-33)."""
        if self.mesh is None:
            return [self.ndof]
        pgrid = tuple(self.mesh.shape[name] for name in self.axis_names)
        return dof_distribution(self.n, pgrid)

    # -- field constructors -------------------------------------------------
    def zeros(self, dtype=None) -> jax.Array:
        from poissbox_tpu.constants import default_real
        return self.shard(jnp.zeros(self.padded_n, dtype or default_real()))

    def random(self, key: jax.Array, dtype=None, minval=-1.0, maxval=1.0) -> jax.Array:
        """Uniform random field in [minval, maxval) — the demo's set_solution
        fills x with uniform [-1, 1) (reference src/example.f90:154-199,
        implemented without its partial-fill loop-bounds bug)."""
        from poissbox_tpu.constants import default_real
        f = jax.random.uniform(key, self.n, dtype or default_real(), minval, maxval)
        return self.shard(f)
