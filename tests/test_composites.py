"""The XLA half-level composites against the float64 oracle: the
down-leg (smooth, residual, restrict; from an iterate and from zero),
the up-leg (prolong, correct, smooth) with the squared residual norm,
and the prolongations they use, in 2D and 3D."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from mgpoisson import oracle
from mgpoisson.kernels import xla

SHAPES = [(16, 16), (64, 64), (8, 8, 8), (16, 16, 16)]
SWEEPS = {"jacobi": oracle.jacobi_sweep, "wjacobi": oracle.wjacobi_sweep,
          "rbgs": oracle.rbgs_sweep}


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _smooth(u, f, h, nu, smoother, bc):
    for _ in range(nu):
        u = SWEEPS[smoother](u, f, h, bc)
    return u


def _close(got, want, rtol=1e-10):
    got = np.asarray(got, np.float64)
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) / scale <= rtol


@pytest.mark.parametrize("shape,bc,smoother", list(itertools.product(
    SHAPES, ["ghost0", "face"], ["wjacobi", "rbgs"])), ids=str)
def test_smooth_residual_restrict(shape, bc, smoother):
    u, f = _rand(shape, 1), _rand(shape, 2)
    h = 1.0 / shape[0]
    got_u, got_R = xla.smooth_residual_restrict(
        jnp.asarray(u), jnp.asarray(f), h, 2, smoother, bc)
    want_u = _smooth(u, f, h, 2, smoother, bc)
    _close(got_u, want_u)
    _close(got_R, oracle.restrict(oracle.residual(want_u, f, h, bc)))
    assert got_R.shape == tuple(s // 2 for s in shape)


@pytest.mark.parametrize("shape,bc", list(itertools.product(
    SHAPES, ["ghost0", "face"])), ids=str)
def test_smooth_residual_restrict_zero(shape, bc):
    f = _rand(shape, 3)
    h = 1.0 / shape[0]
    got_u, got_R = xla.smooth_residual_restrict_zero(
        jnp.asarray(f), h, 3, "wjacobi", bc)
    want_u = _smooth(np.zeros(shape), f, h, 3, "wjacobi", bc)
    _close(got_u, want_u)
    _close(got_R, oracle.restrict(oracle.residual(want_u, f, h, bc)))


@pytest.mark.parametrize("shape,kind,bc", list(itertools.product(
    SHAPES, ["inject", "bilinear"], ["ghost0", "face"])), ids=str)
def test_prolong_correct_smooth(shape, kind, bc):
    coarse = tuple(s // 2 for s in shape)
    u, f, V = _rand(shape, 4), _rand(shape, 5), _rand(coarse, 6)
    h = 1.0 / shape[0]
    got = xla.prolong_correct_smooth(jnp.asarray(u), jnp.asarray(f),
                                     jnp.asarray(V), h, 2, "wjacobi", bc,
                                     kind)
    want = _smooth(u + oracle.prolong(V, kind), f, h, 2, "wjacobi", bc)
    _close(got, want)


@pytest.mark.parametrize("shape,kind", list(itertools.product(
    SHAPES, ["inject", "bilinear"])), ids=str)
def test_prolong_correct_smooth_rnorm(shape, kind):
    coarse = tuple(s // 2 for s in shape)
    u, f, V = _rand(shape, 7), _rand(shape, 8), _rand(coarse, 9)
    h = 1.0 / shape[0]
    args = (jnp.asarray(u), jnp.asarray(f), jnp.asarray(V), h, 1, "rbgs",
            "ghost0", kind)
    got_u, got_r2 = xla.prolong_correct_smooth_rnorm(*args)
    # the fused metric equals a separate residual_sq_sum of the result
    np.testing.assert_allclose(
        float(got_r2), float(xla.residual_sq_sum(got_u, args[1], h)),
        rtol=1e-12)
    want_u = _smooth(u + oracle.prolong(V, kind), f, h, 1, "rbgs",
                     "ghost0")
    _close(got_u, want_u)
    want_r2 = np.sum(oracle.residual(want_u, f, h, "ghost0") ** 2)
    np.testing.assert_allclose(float(got_r2), want_r2, rtol=1e-9)


@pytest.mark.parametrize("shape,kind", list(itertools.product(
    [(2, 2), (8, 8), (32, 32), (2, 2, 2), (8, 8, 8)],
    ["inject", "bilinear"])), ids=str)
def test_prolong(shape, kind):
    V = _rand(shape, 10)
    _close(xla.prolong(jnp.asarray(V), kind), oracle.prolong(V, kind),
           rtol=1e-13)


def test_residual_sq_sum_accumulates_bf16_in_f32():
    u = jnp.asarray(_rand((32, 32), 11), jnp.bfloat16)
    f = jnp.asarray(_rand((32, 32), 12), jnp.bfloat16)
    r2 = xla.residual_sq_sum(u, f, 1.0 / 32)
    assert r2.dtype == jnp.float32
    r = np.asarray(xla.residual(u, f, 1.0 / 32, "ghost0"), np.float64)
    np.testing.assert_allclose(float(r2), np.sum(r * r), rtol=1e-5)
