"""FFT direct Poisson solver — the fully-periodic fast path.

The reference's problem class (uniform, fully periodic box,
reference src/example.f90:24-35) is exactly diagonalized by the DFT: the
discrete 7-point Laplacian's eigenvalues on mode (kx, ky, kz) are

    lambda_k = sum_d (2 cos(2 pi k_d / n_d) - 2) / d_d^2

so A^{-1} is two FFTs and a pointwise divide — machine-precision accurate
in one pass, no iteration. The reference has no such solver (PETSc KSP
only); it is the fastest exact method for the benchmark problem, provided
here as a first-class `ksp_type` alongside the
Krylov methods (which remain the general path — non-periodic BCs, variable
coefficients — and the MG machinery doubles as their preconditioner).

The singular constant mode (k = 0) is the null space; its inverse
eigenvalue is set to zero, which IS the pseudo-inverse — the same
projection semantics as MatNullSpace (reference src/poissbox.f90:284-291).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from poissbox_tpu.solvers.result import ConvergedReason, SolveResult

Array = jax.Array


def _inv_eigenvalues(shape: tuple, deltas: tuple, dtype, rfft: bool):
    """Pseudo-inverse eigenvalues of the periodic 7-point Laplacian, in
    rfft layout (last axis halved) or full-fft layout.

    Evaluated with jnp *inside the trace* — a host-precomputed table would
    be embedded in the compiled program as an O(n^3) literal (33 MB at
    256^3), which bloats executables; the on-device sine evaluation is a
    negligible one-pass cost."""
    nx, ny, nz = shape
    dx, dy, dz = deltas

    def lam(n, d):
        # 2 cos(theta) - 2 == -4 sin^2(theta/2): the sin^2 form is
        # cancellation-free — the difference form loses ~7 digits for low
        # modes in f32 and produces garbage solves
        k = jnp.arange(n, dtype=dtype)
        s = jnp.sin((np.pi / n) * k)
        return (-4.0 / d**2) * s * s

    lz = lam(nz, dz)
    if rfft:
        lz = lz[: nz // 2 + 1]
    eig = (lam(nx, dx)[:, None, None]
           + lam(ny, dy)[None, :, None]
           + lz[None, None, :])
    return jnp.where(eig != 0.0, 1.0 / jnp.where(eig != 0.0, eig, 1.0), 0.0)


def _rfft_last(u: Array) -> Array:
    """Real-input FFT along the LAST axis via the pack-two/unpack trick:
    z_m = u[2m] + i u[2m+1], one half-length complex FFT, Hermitian
    untangle — output length n/2 + 1 (rfft layout). The packed pencil
    solve uses it so that the z transform runs pencil-local on the packed
    half-length array (see :func:`_spectral_solve_pencil_packed`)."""
    n = u.shape[-1]
    n2 = n // 2
    z = jax.lax.complex(u[..., 0::2], u[..., 1::2])
    Z = jnp.fft.fft(z, axis=-1)
    # conj(Z[(n2 - k) % n2]) via flip+roll (flip gives Z[n2-1-j]; rolling
    # by one lands Z[(n2-j) % n2])
    ZN = jnp.conj(jnp.roll(jnp.flip(Z, -1), 1, -1))
    Ze = jnp.concatenate([Z, Z[..., :1]], -1)       # extend to k = n2
    ZNe = jnp.concatenate([ZN, ZN[..., :1]], -1)
    # host-side twiddles (static n)
    W = jnp.asarray(np.exp(-2j * np.pi * np.arange(n2 + 1) / n),
                    dtype=Z.dtype)
    return 0.5 * (Ze + ZNe) - 0.5j * W * (Ze - ZNe)


def _irfft_last(U: Array, n: int) -> Array:
    """Inverse of :func:`_rfft_last` (last axis restored to length n)."""
    n2 = n // 2
    Uc = jnp.conj(jnp.flip(U, -1))                  # conj(U[n2 - k])
    E = (0.5 * (U + Uc))[..., :n2]
    W = jnp.asarray(np.exp(2j * np.pi * np.arange(n2) / n),
                    dtype=U.dtype)
    O = (0.5 * (U - Uc))[..., :n2] * W
    z = jnp.fft.ifft(E + 1j * O, axis=-1)
    out = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
    return out.reshape(U.shape[:-1] + (n,))


def _half_spectrum_solve(b: Array, inv_half: Array) -> Array:
    """x = irfftn(inv_half * rfftn(b)): the real-input 3-D transform pair
    (cuFFT R2C/C2R on the GPU) with a real symbol given in rfft layout
    (last axis n//2 + 1). The symbol must be even in k (symbol(-k) ==
    symbol(k)), so the product stays Hermitian."""
    cplx = jnp.complex64 if b.dtype == jnp.float32 else jnp.complex128
    xhat = jnp.fft.rfftn(b) * inv_half.astype(cplx)
    return jnp.fft.irfftn(xhat, s=b.shape).astype(b.dtype)


@functools.partial(jax.jit, static_argnames=("deltas",))
def _poisson_solve_jit(b: Array, deltas: tuple) -> Array:
    inv = _inv_eigenvalues(tuple(b.shape), deltas, b.dtype, rfft=True)
    return _half_spectrum_solve(b, inv)


def poisson_solve_fft(b: Array, deltas: Sequence[float]) -> Array:
    """x = A^+ b for the periodic 7-point Laplacian, via FFTs.

    Exact (to floating point) for any RHS; the null-space component of b
    is annihilated, so the result is the minimal-norm solution — identical
    semantics to the projected Krylov solves. One route on every backend:
    `jnp.fft.rfftn` / `irfftn`, any extents (odd last axes included).
    """
    return _poisson_solve_jit(b, tuple(float(d) for d in deltas))


# ---------------------------------------------------------------------------
# Distributed spectral solves — pencil-decomposed 3-D FFT
# ---------------------------------------------------------------------------
#
# XLA has no partitioning rule for a 3-D FFT over a sharded spatial array
# (it would all-gather the field). The 2decomp answer — and this framework's
# sequence-parallel machinery (`parallel.pencil`) — is the transpose method:
# 1-D transforms along each axis with that axis device-local, all-to-all
# pencil transposes between, so every FFT is a batched local transform and
# every hop is a single-mesh-axis all-to-all. The spectral divide
# is pointwise and runs in whatever pencil layout the forward pass ends in
# (GSPMD slices the iota-generated eigenvalue field to match).


def _spectral_solve_pencil(b: Array, grid, inv: Array) -> Array:
    """x = F^-1 (inv * F b) with all transforms pencil-local."""
    from jax.sharding import NamedSharding

    from poissbox_tpu.parallel.pencil import from_pencil, pencil_spec, to_pencil

    def pin(f, axis):
        # pin each transform's OUTPUT to the pencil layout as well: left to
        # propagation, the partitioner may shard an FFT along its transform
        # axis (its fft handler also miscompiles c128 — emits c64 constants)
        return jax.lax.with_sharding_constraint(
            f, NamedSharding(grid.mesh, pencil_spec(grid, axis)))

    cplx = jnp.complex64 if b.dtype == jnp.float32 else jnp.complex128
    f = b.astype(cplx)
    prev: int | None = None
    for axis in (2, 1, 0):
        f = to_pencil(f, grid, axis, from_dim=prev)
        f = pin(jnp.fft.fft(f, axis=axis), axis)
        prev = axis
    f = f * inv.astype(cplx)
    for axis in (0, 1, 2):  # starts where the forward pass ended (x-pencils)
        f = to_pencil(f, grid, axis, from_dim=prev)
        f = pin(jnp.fft.ifft(f, axis=axis), axis)
        prev = axis
    return from_pencil(f, grid, from_dim=prev).real.astype(b.dtype)


def _z_shard_product(grid) -> int:
    """Product of mesh-axis sizes sharding array dim 2 in the grid's home
    layout (the axes that shard the halved spectrum in y/x pencils)."""
    spec = list(grid.spec) + [None] * (3 - len(grid.spec))
    entry = spec[2]
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    p = 1
    for nm in names:
        p *= grid.mesh.shape[nm]
    return p


def _packed_dist_ok(b: Array, grid) -> bool:
    nz = b.shape[-1]
    return nz % 2 == 0 and (nz // 2) % _z_shard_product(grid) == 0


def _spectral_solve_pencil_packed(b: Array, grid, inv_half: Array) -> Array:
    """Packed-real pencil spectral solve: the z transform runs as the
    half-length packed-real FFT in Z-pencils, and everything downstream —
    transposes AND y/x transforms — operates on the HALVED spectrum, so
    the all-to-all bytes and transform work both drop ~2x vs the complex
    path. The Nyquist plane (k_z = n/2) rides as a separate (nx, ny, 1)
    array, REPLICATED once on every device (per-orientation resharding of
    a length-1 dim trips GSPMD's involuntary-rematerialization fallback —
    observed 7.5 MB of gathers at 64^3 — while one small gather plus
    redundant tiny transforms is ~free)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from poissbox_tpu.parallel.pencil import from_pencil, pencil_spec, to_pencil

    nz = b.shape[-1]
    n2 = nz // 2

    def pin(f, axis):
        return jax.lax.with_sharding_constraint(
            f, NamedSharding(grid.mesh, pencil_spec(grid, axis)))

    repl = NamedSharding(grid.mesh, PartitionSpec())
    cplx = jnp.complex64 if b.dtype == jnp.float32 else jnp.complex128
    # Z-pencils: local packed-real transform along z
    f = to_pencil(b, grid, 2, from_dim=None)
    U = pin(_rfft_last(f).astype(cplx), 2)
    body = U[..., :n2]
    # the Nyquist plane: gather once (tiny), then every device carries it
    nyq = jax.lax.with_sharding_constraint(U[..., n2:], repl)
    prev = 2
    for axis in (1, 0):
        body = pin(jnp.fft.fft(to_pencil(body, grid, axis, from_dim=prev),
                               axis=axis), axis)
        nyq = jax.lax.with_sharding_constraint(
            jnp.fft.fft(nyq, axis=axis), repl)
        prev = axis
    body = body * inv_half[..., :n2].astype(cplx)
    nyq = nyq * inv_half[..., n2:].astype(cplx)
    for axis in (0, 1):
        body = pin(jnp.fft.ifft(to_pencil(body, grid, axis, from_dim=prev),
                                axis=axis), axis)
        nyq = jax.lax.with_sharding_constraint(
            jnp.fft.ifft(nyq, axis=axis), repl)
        prev = axis
    body = to_pencil(body, grid, 2, from_dim=prev)
    x = _irfft_last(jnp.concatenate([body, nyq], axis=-1), nz)
    return from_pencil(pin(x.astype(b.dtype), 2), grid, from_dim=2)


def poisson_solve_fft_dist(b: Array, grid) -> Array:
    """Distributed x = A^+ b for the periodic 7-point Laplacian: the exact
    direct solve at any device count (the reference's PETSc path has no
    direct solver at all; its distributed solves are Krylov-only,
    reference src/poissbox.f90:293-296). Uses the packed-real pencil path
    (half the transpose bytes and transform work) when the halved
    spectrum divides the z-sharding; complex pencils otherwise."""
    if grid.mesh is None or grid.mesh.size == 1:
        return poisson_solve_fft(b, grid.deltas)
    if getattr(grid, "uneven", False):
        # non-divisible decomposition: pencil transposes need divisible
        # shards, so gather the valid cells, solve replicated, scatter
        # back into the padded layout (capability fallback; the Krylov
        # paths remain the distributed-efficient option on uneven grids)
        from poissbox_tpu.parallel.uneven import from_padded, to_padded
        x = _poisson_solve_jit(from_padded(b, grid),
                               tuple(float(d) for d in grid.deltas))
        return jax.lax.with_sharding_constraint(to_padded(x, grid),
                                                grid.sharding)
    if _packed_dist_ok(b, grid):
        inv = _inv_eigenvalues(tuple(b.shape),
                               tuple(float(d) for d in grid.deltas),
                               b.dtype, rfft=True)
        return _spectral_solve_pencil_packed(b, grid, inv)
    inv = _inv_eigenvalues(tuple(b.shape),
                           tuple(float(d) for d in grid.deltas),
                           b.dtype, rfft=False)
    return _spectral_solve_pencil(b, grid, inv)


def compact_poisson_solve_fft_dist(b: Array, grid) -> Array:
    """Distributed 6th-order compact Poisson direct solve (pencil FFTs +
    the rational trigonometric symbol); packed-real pencils when the
    halved spectrum divides the z-sharding (the symbol is Hermitian, so
    its half layout is a slice)."""
    if grid.mesh is None or grid.mesh.size == 1:
        return compact_poisson_solve_fft(b, grid.deltas)
    if getattr(grid, "uneven", False):
        # see poisson_solve_fft_dist: gather-solve-scatter fallback
        from poissbox_tpu.parallel.uneven import from_padded, to_padded
        x = compact_poisson_solve_fft(from_padded(b, grid), grid.deltas)
        return jax.lax.with_sharding_constraint(to_padded(x, grid),
                                                grid.sharding)
    inv = compact_inv_eigenvalues(tuple(b.shape),
                                  tuple(float(d) for d in grid.deltas),
                                  b.dtype)
    if _packed_dist_ok(b, grid):
        return _spectral_solve_pencil_packed(
            b, grid, inv[..., : b.shape[-1] // 2 + 1])
    return _spectral_solve_pencil(b, grid, inv)


def make_fft_preconditioner(deltas: Sequence[float], grid=None):
    """The exact periodic inverse as a PRECONDITIONER (`-pc_type fft`).

    For the uniform 7-point operator itself this makes any Krylov method
    converge in one iteration; its real use is as a spectrally-equivalent
    preconditioner for operators the FFT does NOT diagonalize into the same
    symbol — the 6th-order compact system (2nd-order symbol ~ 6th-order
    symbol uniformly in k), and variable-coefficient extensions, where it
    plays the role GAMG plays for the reference's assembled matrix."""
    deltas = tuple(float(d) for d in deltas)
    if grid is not None and grid.mesh is not None and grid.mesh.size > 1:
        return lambda r: poisson_solve_fft_dist(r, grid)
    return lambda r: poisson_solve_fft(r, deltas)


def fft_solver_result(A, b: Array, deltas: Sequence[float],
                      grid=None) -> SolveResult:
    """Run the direct solve and wrap it as a SolveResult (one 'iteration',
    residual measured, PETSc-style reason code). Uses the operator's own
    spectral solve when it provides one (7-point or compact 6th-order)."""
    if getattr(A, "direct_solve", None) is not None:
        x = A.direct_solve(b)
    elif grid is not None and grid.mesh is not None and grid.mesh.size > 1:
        x = poisson_solve_fft_dist(b, grid)
    else:
        x = poisson_solve_fft(b, deltas)
    r = A.project(b) - A(x)
    resnorm = jnp.sqrt(jnp.sum(r * r))
    hist = jnp.stack([jnp.sqrt(jnp.sum(b * b)), resnorm])
    return SolveResult(
        x=x,
        iterations=jnp.int32(1),
        residual_norm=resnorm,
        history=hist,
        reason=jnp.int32(ConvergedReason.CONVERGED_ATOL),
    )


# ---------------------------------------------------------------------------
# 6th-order compact Laplacian — spectral symbol and direct solve
# ---------------------------------------------------------------------------
#
# The compact-scheme operators are periodic and shift-invariant, so the DFT
# diagonalizes them too. The reference never wires its compact stack into a
# solver (the stacks are disjoint, reference CHANGELOG.md:9-20); here the
# 6th-order Poisson system is solved directly. Each 1-D operator has the
# rational trigonometric symbol
#
#   T(theta) = R(theta) / L(theta),   L = 1 + 2 alpha cos(theta)
#   R = a (e^{i sh th} + s e^{i(sh-1)th}) + b (e^{i(sh+1)th} + s e^{i(sh-2)th})
#
# (taps from compact_rhs, reference src/compact_schemes.f90:332-372), and the
# composed 3-D Laplacian div(grad) symbol is
#
#   S = sum_d D_d G_d * prod_{e != d} I_e I'_e
#
# per the sweep structure (reference :17-37). NOTE the staggered interp
# annihilates Nyquist modes (I(pi) = 0), so the compact Laplacian's kernel
# is larger than span{1}: the direct solve is the minimal-norm PSEUDO-
# inverse, zeroing all kernel modes.

def _op_symbol(theta, a: float, b: float, opsign: int, shift: int,
               alpha: float):
    s = float(opsign)
    e = lambda m: jnp.exp(1j * m * theta)
    R = (a * (e(shift) + s * e(shift - 1))
         + b * (e(shift + 1) + s * e(shift - 2)))
    return R / (1.0 + 2.0 * alpha * jnp.cos(theta))


def compact_inv_eigenvalues(shape, deltas, dtype):
    """Pseudo-inverse eigenvalues of the 6th-order compact Laplacian, in
    full-fft layout, evaluated on-device (no giant compile-time literals)."""
    from poissbox_tpu.ops.coefficients import (
        compact_grad_coeffs,
        compact_interp_coeffs,
    )
    cplx = jnp.complex64 if jnp.dtype(dtype) == jnp.float32 else jnp.complex128
    real = jnp.float32 if cplx == jnp.complex64 else jnp.float64
    ci = compact_interp_coeffs()

    def axis_parts(n, d):
        theta = (2.0 * jnp.pi / n) * jnp.arange(n, dtype=real)
        cg = compact_grad_coeffs(d)
        G = _op_symbol(theta, cg.a, cg.b, -1, 0, cg.alpha)   # grad, cell->vtx
        D = _op_symbol(theta, cg.a, cg.b, -1, 1, cg.alpha)   # div', vtx->cell
        I = _op_symbol(theta, ci.a, ci.b, +1, 0, ci.alpha)   # interp
        Ip = _op_symbol(theta, ci.a, ci.b, +1, 1, ci.alpha)  # interp'
        return (D * G).astype(cplx), (I * Ip).astype(cplx)

    nx, ny, nz = shape
    dx, dy, dz = deltas
    DGx, IIx = axis_parts(nx, dx)
    DGy, IIy = axis_parts(ny, dy)
    DGz, IIz = axis_parts(nz, dz)
    S = (DGx[:, None, None] * IIy[None, :, None] * IIz[None, None, :]
         + IIx[:, None, None] * DGy[None, :, None] * IIz[None, None, :]
         + IIx[:, None, None] * IIy[None, :, None] * DGz[None, None, :])
    mag = jnp.abs(S)
    tol = (1e-6 if cplx == jnp.complex64 else 1e-12) * jnp.max(mag)
    return jnp.where(mag > tol, 1.0 / jnp.where(mag > tol, S, 1.0),
                     0.0).astype(cplx)


@functools.partial(jax.jit, static_argnames=("deltas",))
def _compact_solve_jit(b, deltas):
    # the compact symbol is REAL and even in k (the staggered half-shift
    # phases cancel in each D*G and I*I' product), so its half spectrum
    # is a slice and the real-input transform pair applies
    inv = compact_inv_eigenvalues(tuple(b.shape), deltas, b.dtype)
    return _half_spectrum_solve(b, jnp.real(inv[..., : b.shape[-1] // 2 + 1]))


def compact_poisson_solve_fft(b: Array, deltas: Sequence[float]) -> Array:
    """x = A^+ b for the 6th-order compact Laplacian — the high-order
    direct solve the reference lacks entirely."""
    return _compact_solve_jit(b, tuple(float(d) for d in deltas))
