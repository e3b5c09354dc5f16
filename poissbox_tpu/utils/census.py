"""Communication census — count and size collectives in compiled HLO.

The reference's DMDA contract promises exactly one width-1 halo exchange
per operator application plus the reduction collectives of CG
(reference src/poissbox.f90:104-105; SURVEY.md §5.8's communication
pattern census). The same contract must hold in the *optimized
HLO* that GSPMD emits — and nothing else: an accidental resharding shows
up as an all-gather, a botched pencil transpose as a replicate+reslice
instead of an all-to-all. This module parses the compiled module text
into per-computation collective counts and byte volumes, and provides
the analytic models the compiled programs are asserted against
(tests/test_scaling_model.py; `__graft_entry__.dryrun_multichip`
prints the census of its sharded solves).

Byte volumes are PER-DEVICE payload bytes (the operand shapes in SPMD
HLO are already per-partition).
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# base collective opcodes (the -start/-done async split is normalized away;
# only starts are counted so sync and async forms census identically)
_OPS = ("collective-permute", "all-reduce", "all-to-all", "all-gather",
        "reduce-scatter", "collective-broadcast", "ragged-all-to-all")

_CALL_RE = re.compile(r"\s(" + "|".join(_OPS) + r")(-start)?\(")
_SHAPE_RE = re.compile(r"\b([a-z]+\d*)\[([\d,]*)\]")
_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
_WHILE_BODY_RE = re.compile(r"\bbody=%?([\w.\-]+)")


@dataclass(frozen=True)
class Collective:
    op: str            # normalized opcode (no -start)
    bytes: int         # per-device operand payload bytes
    computation: str   # enclosing HLO computation name


def _payload_bytes(result_txt: str) -> int:
    """Payload of a collective from its RESULT type: the largest
    non-scalar-integer buffer. (Optimized HLO may print operands untyped,
    so the result is the reliable shape source. Async `-start` forms
    return a tuple aliasing equal-shaped in/out buffers plus u32 context
    scalars — the max is exactly one communicated buffer; all-gather
    starts report the gathered output, the natural 'gather size'.)"""
    best = 0
    for m in _SHAPE_RE.finditer(result_txt):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        if not dims and dt not in ("f32", "f64", "bf16", "f16"):
            continue  # u32[] async-context scalars
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        best = max(best, n * _DTYPE_BYTES[dt])
    return best


def parse_collectives(hlo: str) -> list[Collective]:
    """Every collective op in the module, tagged with its computation.
    `-done` halves of async pairs are skipped (the `-start` carries the
    census entry)."""
    out: list[Collective] = []
    comp = "?"
    for raw in hlo.splitlines():
        if raw[:1] not in (" ", "\t"):
            m = _HEADER_RE.match(raw.strip())
            if m and raw.rstrip().endswith("{"):
                comp = m.group(1)
            continue
        m = _CALL_RE.search(raw)
        if m is None or "-done(" in raw:
            continue
        eq = raw.find("= ")
        result_txt = raw[eq + 2:m.start()] if eq >= 0 else raw[:m.start()]
        out.append(Collective(op=m.group(1),
                              bytes=_payload_bytes(result_txt),
                              computation=comp))
    return out


def census(hlo: str, computation: Optional[str] = None) -> dict:
    """{opcode: {"count": n, "bytes": total_per_device_bytes}}, optionally
    restricted to one computation (substring match, e.g. a while body)."""
    stats: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for c in parse_collectives(hlo):
        if computation is not None and computation not in c.computation:
            continue
        stats[c.op]["count"] += 1
        stats[c.op]["bytes"] += c.bytes
    return dict(stats)


def while_bodies(hlo: str) -> list[str]:
    """Names of while-loop body computations (the Krylov iteration lives
    in one of these)."""
    return list(dict.fromkeys(_WHILE_BODY_RE.findall(hlo)))


def max_gather_bytes(hlo: str) -> int:
    """Largest single all-gather payload in the module — the
    'accidental replication' tripwire. Legitimate gathers exist only at
    the MG level transition to replicated coarse grids, so this must stay
    at coarse-level size."""
    return max((c.bytes for c in parse_collectives(hlo)
                if c.op == "all-gather"), default=0)


# ---------------------------------------------------------------------------
# analytic models
# ---------------------------------------------------------------------------

def _sharded_axes(grid) -> list[tuple[int, int]]:
    """[(array_dim, mesh_size)] for dims sharded over >1 devices."""
    if grid.mesh is None:
        return []
    names = list(grid.spec) + [None] * (3 - len(grid.spec))
    out = []
    for d, name in enumerate(names):
        if name is None:
            continue
        for nm in (name if isinstance(name, tuple) else (name,)):
            p = grid.mesh.shape[nm]
            if p > 1:
                out.append((d, p))
    return out


def halo_model(grid, itemsize: int = 4, n_exchanges: int = 1) -> dict:
    """Expected collective-permute census for `n_exchanges` width-1 halo
    exchanges of one field (dist_stencil._halo_diffs: 2 permutes per
    sharded dim, each moving one per-device face plane)."""
    from poissbox_tpu.parallel.dist_stencil import local_shape

    loc = local_shape(grid)
    count, total = 0, 0
    for d, _p in _sharded_axes(grid):
        face = itemsize
        for i, n in enumerate(loc):
            face *= 1 if i == d else n
        count += 2
        total += 2 * face
    return {"count": count * n_exchanges, "bytes": total * n_exchanges}


def _move_count(from_spec, to_spec) -> int:
    """Number of single-mesh-axis moves reshard_chain makes between two
    specs — each lowers to exactly one all-to-all under GSPMD."""
    from poissbox_tpu.parallel.pencil import _entries

    cur = _entries(from_spec)
    dst = _entries(to_spec)
    moves = 0
    for d in range(3):
        for n in dst[d]:
            src = next(i for i, names in enumerate(cur) if n in names)
            if src == d:
                continue
            cur[src].remove(n)
            cur[d].append(n)
            moves += 1
    return moves


def pencil_lapl_model(grid, itemsize: int = 4) -> dict:
    """Expected all-to-all census of `compact_dist.lapl` (div∘grad):
    replay the exact to_pencil/from_pencil spec transitions of
    compact_dist.grad/div and count reshard_chain's single-axis moves.
    Each all-to-all moves the device's whole local block."""
    from poissbox_tpu.parallel.pencil import pencil_spec

    if grid.mesh is None:
        return {"count": 0, "bytes": 0}
    home = grid.spec
    p = {d: pencil_spec(grid, d) for d in range(3)}
    transitions = (
        # grad (compact_dist.grad): Z sweep <- home, Y sweep x2, X sweep x3,
        # then 3 components home
        [(home, p[2])] + [(p[2], p[1])] * 2 + [(p[1], p[0])] * 3
        + [(p[0], home)] * 3
        # div (compact_dist.div): X sweep x3 <- home, Y x3, Z x2, out home
        + [(home, p[0])] * 3 + [(p[0], p[1])] * 3 + [(p[1], p[2])] * 2
        + [(p[2], home)]
    )
    moves = sum(_move_count(a, b) for a, b in transitions)
    block = itemsize
    from poissbox_tpu.parallel.dist_stencil import local_shape
    for n in local_shape(grid):
        block *= n
    return {"count": moves, "bytes": moves * block}
