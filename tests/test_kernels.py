"""Differential tests: JAX XLA kernels vs the float64 NumPy oracle —
per-op, random inputs, both bcs, 2D and 3D (the reference's
cross-implementation diffing mechanism, `cpu-raw.lua:120-140`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mgpoisson import oracle
from mgpoisson.kernels import xla

SHAPES = [(8, 8), (16, 16), (8, 8, 8)]
# the 2D sweeps are cases of tests/test_smoother_diff.py
SWEEP_SHAPES = [(8, 8, 8)]
BCS = ["ghost0", "face"]


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bc", BCS)
def test_neighbor_sum(shape, bc):
    u = _rand(shape)
    got = np.asarray(xla.neighbor_sum(jnp.asarray(u), bc))
    np.testing.assert_allclose(got, oracle.neighbor_sum(u, bc), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=str)
@pytest.mark.parametrize("bc", BCS)
def test_jacobi_sweep(shape, bc):
    u, f = _rand(shape, 1), _rand(shape, 2)
    h = 1.0 / shape[0]
    got = np.asarray(xla.jacobi_sweep(jnp.asarray(u), jnp.asarray(f), h, bc))
    np.testing.assert_allclose(got, oracle.jacobi_sweep(u, f, h, bc),
                               rtol=1e-12)


@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=str)
@pytest.mark.parametrize("bc", BCS)
def test_rbgs_sweep(shape, bc):
    u, f = _rand(shape, 3), _rand(shape, 4)
    h = 1.0 / shape[0]
    got = np.asarray(xla.rbgs_sweep(jnp.asarray(u), jnp.asarray(f), h, bc))
    np.testing.assert_allclose(got, oracle.rbgs_sweep(u, f, h, bc),
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bc", BCS)
def test_residual(shape, bc):
    u, f = _rand(shape, 5), _rand(shape, 6)
    h = 1.0 / shape[0]
    got = np.asarray(xla.residual(jnp.asarray(u), jnp.asarray(f), h, bc))
    np.testing.assert_allclose(got, oracle.residual(u, f, h, bc), rtol=1e-11,
                               atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_restrict(shape):
    r = _rand(shape, 7)
    got = np.asarray(xla.restrict(jnp.asarray(r)))
    np.testing.assert_allclose(got, oracle.restrict(r), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("shape", [(4, 4), (8, 8), (4, 4, 4)], ids=str)
@pytest.mark.parametrize("kind", ["inject", "bilinear"])
def test_prolong(shape, kind):
    V = _rand(shape, 8)
    got = np.asarray(xla.prolong(jnp.asarray(V), kind))
    np.testing.assert_allclose(got, oracle.prolong(V, kind), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("kind", ["inject", "bilinear"])
def test_prolong_correct_fusion(kind):
    V, u = _rand((4, 4), 9), _rand((8, 8), 10)
    got = np.asarray(xla.prolong_correct(jnp.asarray(u), jnp.asarray(V), kind))
    np.testing.assert_allclose(got, u + oracle.prolong(V, kind), rtol=1e-13)


@pytest.mark.parametrize("bc", BCS)
def test_residual_restrict_fusion(bc):
    u, f = _rand((16, 16), 11), _rand((16, 16), 12)
    h = 1.0 / 16
    got = np.asarray(xla.residual_restrict(jnp.asarray(u), jnp.asarray(f), h, bc))
    np.testing.assert_allclose(got, oracle.restrict(oracle.residual(u, f, h, bc)),
                               rtol=1e-11, atol=1e-9)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_coarse_solve_1x1(bc, smoother):
    f = np.array([[6.0]])
    u = np.zeros((1, 1))
    got = np.asarray(xla.coarse_solve(jnp.asarray(u), jnp.asarray(f), 1.0,
                                      smoother, bc))
    np.testing.assert_allclose(got, oracle.coarse_solve(u, f, 1.0, smoother, bc),
                               rtol=1e-13)


def test_metrics():
    a, b = _rand((8, 8), 13), _rand((8, 8), 14)
    np.testing.assert_allclose(
        float(xla.rms_update(jnp.asarray(a), jnp.asarray(b))),
        oracle.rms_update(a, b), rtol=1e-12)
    np.testing.assert_allclose(
        float(xla.rel_err(jnp.asarray(a), jnp.asarray(b))),
        oracle.rel_err(a, b), rtol=1e-12)
    f = _rand((8, 8), 15)
    np.testing.assert_allclose(
        float(xla.residual_norm(jnp.asarray(a), jnp.asarray(f), 0.125)),
        oracle.residual_norm(a, f, 0.125), rtol=1e-12)


def test_rel_err_mask_edge_cases():
    old = jnp.zeros((4, 4))
    new = jnp.ones((4, 4))
    # all cells masked out (old == 0) -> 0, no NaN
    assert float(xla.rel_err(new, old)) == 0.0


@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=str)
@pytest.mark.parametrize("bc", BCS)
def test_wjacobi_sweep(shape, bc):
    u, f = _rand(shape, 21), _rand(shape, 22)
    h = 1.0 / shape[0]
    got = np.asarray(xla.wjacobi_sweep(jnp.asarray(u), jnp.asarray(f), h, bc))
    np.testing.assert_allclose(got, oracle.wjacobi_sweep(u, f, h, bc),
                               rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gs_lex_sweep(shape):
    # lexicographic Gauss-Seidel (`cpu.lua:24-37`): the scan-based XLA
    # form must reproduce the oracle's strictly sequential update order
    # (ghost0 only, like the reference)
    u, f = _rand(shape, 31), _rand(shape, 32)
    h = 1.0 / shape[0]
    got = np.asarray(xla.gs_lex_sweep(jnp.asarray(u), jnp.asarray(f), h))
    np.testing.assert_allclose(got, oracle.gs_lex_sweep(u, f, h),
                               rtol=1e-11, atol=1e-12)
    # multi-sweep through the public smooth() dispatch
    got3 = np.asarray(xla.smooth(jnp.asarray(u), jnp.asarray(f), h, 3,
                                 "gs_lex"))
    want3 = u.copy()
    for _ in range(3):
        want3 = oracle.gs_lex_sweep(want3, f, h)
    np.testing.assert_allclose(got3, want3, rtol=1e-10, atol=1e-11)


def test_gs_lex_rejects_face_bc():
    u = jnp.zeros((8, 8))
    with pytest.raises(ValueError):
        xla.gs_lex_sweep(u, u, 0.125, bc="face")
