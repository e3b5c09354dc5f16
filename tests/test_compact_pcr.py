"""PCR compact-operator tests.

The circulant-PCR path must agree with the Thomas-backed operators and
with a dense numpy solve (all are direct solves of the same systems) to
f64 roundoff, along every axis and at several line lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poissbox_tpu.ops import compact, compact_pcr

from conftest import rms as _rms  # noqa: F401  (fixture import pattern)


def rms(x):
    return float(jnp.sqrt(jnp.mean(jnp.asarray(x) ** 2)))


class TestPcrSolve:
    def test_schedule_solves_circulant_system(self, rng):
        for n in (8, 64, 128):
            for alpha in (9.0 / 62.0, 3.0 / 10.0):
                A = np.zeros((n, n))
                for i in range(n):
                    A[i, i] = 1.0
                    A[i, (i - 1) % n] = alpha
                    A[i, (i + 1) % n] = alpha
                x = rng.standard_normal((n, 3))
                d = jnp.asarray(A @ x)
                fs, bF, aF = compact_pcr.pcr_schedule(alpha, n)
                got = compact_pcr._vpcr(d, 0, (fs, bF, aF))
                assert np.max(np.abs(np.asarray(got) - x)) < 1e-12

    def test_pcr_op_matches_thomas_1d(self, rng):
        """pcr_op == grad_1d/interp_1d (Thomas path) along every axis."""
        n = 32
        f = jnp.asarray(rng.uniform(-1.0, 1.0, (n, n, n)))
        dx = 1.0 / n
        for axis in (0, 1, 2):
            want = compact.grad_1d(f, dx, axis=axis, method="pscan")
            got = compact_pcr.pcr_op(f, compact_pcr.grad_spec(dx, -1, n),
                                     axis)
            assert float(jnp.max(jnp.abs(want - got))) < 1e-11
            want = compact.interp_1d(f, axis=axis, method="pscan")
            got = compact_pcr.pcr_op(f, compact_pcr.interp_spec(-1, n), axis)
            assert float(jnp.max(jnp.abs(want - got))) < 1e-12

    def test_non_power_of_two_exact_rejected(self):
        # the EXACT (rtol=0) ladder needs the final (i, i+n/2) pairing,
        # which is power-of-two-only; truncated schedules are n-agnostic
        with pytest.raises(ValueError):
            compact_pcr.pcr_schedule(0.25, 48)
        with pytest.raises(ValueError):
            compact_pcr.pcr_schedule(0.25, 2)
        fs, _, aF = compact_pcr.pcr_schedule(0.25, 48, rtol=1e-15)
        assert fs and aF == 0.0

    def test_non_power_of_two_truncated_solves(self, rng):
        """The truncated schedule is n-agnostic (circulant elimination is
        exact operator algebra for any stride mod n): 640 = 5*2^7 runs the
        same scan-free path as 512, and short lines work too."""
        for n in (3, 10, 12, 20, 40, 48, 96, 160, 640):
            for alpha in (9.0 / 62.0, 3.0 / 10.0):
                A = np.zeros((n, n))
                for i in range(n):
                    A[i, i] = 1.0
                    A[i, (i - 1) % n] = alpha
                    A[i, (i + 1) % n] = alpha
                x = rng.standard_normal((n, 3))
                d = jnp.asarray(A @ x)
                sched = compact_pcr.pcr_schedule(alpha, n, rtol=1e-15)
                got = compact_pcr._vpcr(d, 0, sched)
                assert np.max(np.abs(np.asarray(got) - x)) < 1e-11, n

    def test_pcr_op_non_power_of_two_matches_thomas(self, rng):
        n = 40
        f = jnp.asarray(rng.uniform(-1.0, 1.0, (n, n, n)))
        dx = 1.0 / n
        rt = 1e-15
        for axis in (0, 1, 2):
            want = compact.grad_1d(f, dx, axis=axis, method="pscan")
            got = compact_pcr.pcr_op(
                f, compact_pcr.grad_spec(dx, -1, n, rt), axis)
            assert float(jnp.max(jnp.abs(want - got))) < 1e-10




def _dense_compact_1d(f, coeffs, stagger, axis):
    """Dense numpy reference of one staggered compact operator along
    `axis`: the circulant RHS matrix R and the circulant (alpha, 1, alpha)
    system L, applied as L^-1 R to every line."""
    n = f.shape[axis]
    shift = 0 if stagger == -1 else 1
    s = float(coeffs.opsign)
    R = np.zeros((n, n))
    L = np.eye(n)
    for i in range(n):
        for k, w in ((shift, coeffs.a), (shift - 1, s * coeffs.a),
                     (shift + 1, coeffs.b), (shift - 2, s * coeffs.b)):
            R[i, (i + k) % n] += w
        L[i, (i - 1) % n] += coeffs.alpha
        L[i, (i + 1) % n] += coeffs.alpha
    op = np.linalg.solve(L, R)
    return np.moveaxis(np.tensordot(op, np.moveaxis(f, axis, 0), axes=1),
                       0, axis)


class TestPcrAgainstDense:
    """pcr_op (the default line solve) vs pscan (the Thomas reference) vs
    a dense numpy solve, along every axis, at power-of-two and other n."""

    @pytest.mark.parametrize("n", [8, 12, 40, 64])
    @pytest.mark.parametrize("axis", [0, 1, 2])
    def test_grad_and_interp(self, rng, n, axis):
        from poissbox_tpu.ops.coefficients import (
            compact_grad_coeffs,
            compact_interp_coeffs,
        )
        shape = [6, 5, 7]
        shape[axis] = n
        f = rng.uniform(-1.0, 1.0, shape)
        dx = 1.0 / n
        rt = compact_pcr._dtype_rtol(jnp.float64)
        specs = [compact_pcr.grad_spec(dx, st, n, rt) for st in (-1, 1)]
        specs += [compact_pcr.interp_spec(st, n, rt) for st in (-1, 1)]

        @jax.jit
        def run(v):
            pcr = [compact_pcr.pcr_op(v, sp, axis) for sp in specs]
            thomas = [compact.grad_1d(v, dx, stagger=st, axis=axis,
                                      method="pscan") for st in (-1, 1)]
            return pcr, thomas

        pcr, thomas = run(jnp.asarray(f))
        wants = [_dense_compact_1d(f, compact_grad_coeffs(dx), st, axis)
                 for st in (-1, 1)]
        wants += [_dense_compact_1d(f, compact_interp_coeffs(), st, axis)
                  for st in (-1, 1)]
        for got, want in zip(pcr + thomas, wants + wants[:2]):
            scale = np.max(np.abs(want))
            assert np.max(np.abs(np.asarray(got) - want)) < 1e-13 * scale


class TestMethodChoice:
    def test_default_method_is_known(self):
        assert compact.DEFAULT_METHOD in compact.METHODS

    @pytest.mark.parametrize("method", ["pallas", "thomas", ""])
    def test_removed_or_unknown_method_rejected(self, method):
        f = jnp.ones((8, 8, 8))
        with pytest.raises(ValueError, match="method"):
            compact.grad_1d(f, 0.125, axis=0, method=method)

    @pytest.mark.parametrize("method", ["pcr", "pscan", "seq"])
    def test_lapl_methods_agree(self, rng, method):
        n = 16
        f = jnp.asarray(rng.uniform(-1.0, 1.0, (n, n, 12)))
        d = (1.0 / n, 1.0 / n, 1.0 / 12)
        lapl = jax.jit(compact.lapl, static_argnums=(1, 2))
        want = np.asarray(lapl(f, d, "pscan"))
        got = np.asarray(lapl(f, d, method))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.max(np.abs(want)))
