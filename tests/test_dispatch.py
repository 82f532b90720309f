"""Which implementation each level gets, the Hopper kernel's wrapper,
the compile-cache helper and the peak table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mgpoisson.kernels as K
from mgpoisson import Spec
from mgpoisson.bench import roofline
from mgpoisson.kernels import hopper, xla
from mgpoisson.utils import compile_cache


# ------------------------------------------------------------- get_ops

@pytest.mark.parametrize("size", [8, 4096, 16384])
def test_cpu_levels_run_xla(size):
    assert K.get_ops(Spec(size=16384), size) is xla


@pytest.mark.parametrize("ndim", [2, 3])
def test_pallas_backend_refused_off_gpu(ndim):
    with pytest.raises(ValueError, match="needs a GPU"):
        K.get_ops(Spec(size=64, ndim=ndim, backend="pallas"), 64)


GPU_CASES = [
    # (spec kwargs, level size, kernel expected)
    (dict(size=8192), 8192, True),                      # tuned, wjacobi 3
    (dict(size=8192), 4096, True),                      # at the threshold
    (dict(size=8192), 2048, False),                     # below it
    (dict(size=8192, pallas_min_size=1024), 1024, True),
    (dict(size=8192, dtype="bfloat16"), 8192, False),
    (dict(size=8192, dtype="float64"), 8192, False),
    (dict(size=8192, scheme="fast"), 8192, False),      # rbgs 1+1
    (dict(size=8192, scheme="reference"), 8192, True),   # jacobi 7+7
    (dict(size=8192, scheme="reference", pre_smooth=2, post_smooth=2),
     8192, False),
    (dict(size=8192, pre_smooth=1, post_smooth=1), 8192, False),
    (dict(size=8192, pre_smooth=3, post_smooth=1), 8192, False),
    (dict(size=8192, pre_smooth=4, post_smooth=4), 8192, True),
    (dict(size=512, ndim=3), 512, False),
    (dict(size=8192, mesh_shape=(2, 2)), 8192, False),
    (dict(size=8192, backend="xla"), 8192, False),
    (dict(size=8192, backend="pallas"), 8192, True),
]


@pytest.mark.parametrize("kw,level,kernel", GPU_CASES, ids=str)
def test_gpu_dispatch(monkeypatch, kw, level, kernel):
    monkeypatch.setattr(K, "on_gpu", lambda: True)
    got = K.get_ops(Spec(**kw), level)
    assert got is (hopper if kernel else xla)


def test_solver_builds_on_the_dispatch_without_a_gpu():
    # the V-cycle asks get_ops per level; on the CPU every level is XLA
    from mgpoisson import MultigridPoisson
    res = MultigridPoisson(Spec(size=32, dtype="float64", backend="auto",
                                stop="residual", tol=1e-8)).solve()
    assert res.converged


# ------------------------------------------------------ kernel wrapper

@pytest.mark.parametrize("shape,dtype,smoother,nu,ok", [
    ((64, 64), jnp.float32, "wjacobi", 3, True),
    ((64, 64), jnp.bfloat16, "rbgs", 2, True),
    ((64, 64, 64), jnp.float32, "wjacobi", 3, False),
    ((64, 64), jnp.float64, "jacobi", 2, False),
    ((64, 64), jnp.float32, "gs_lex", 1, False),
    ((64, 64), jnp.float32, "wjacobi", 0, False),
    ((64, 64), jnp.float32, "rbgs", 8, False),          # halo > block
])
def test_supports(shape, dtype, smoother, nu, ok):
    assert hopper.supports(shape, dtype, smoother, nu) is ok


@pytest.mark.parametrize("shape,smoother,nu,block,tiles", [
    ((100, 100), "wjacobi", 3, (32, 128), (4, 1)),     # 26 x 120 interiors
    ((4096, 4096), "wjacobi", 3, (32, 128), (158, 35)),
    ((4096, 4096), "rbgs", 1, (16, 128), (342, 35)),
    ((8, 8), "jacobi", 1, (32, 64), (1, 1)),
])
def test_plan_tiles(shape, smoother, nu, block, tiles):
    hr, hc, tm, tn, got, nprog, steps = hopper._plan(shape, smoother, nu,
                                                     block, 1056)
    assert got == tiles
    assert tm == block[0] - 2 * hr and tn == block[1] - 2 * hc
    assert hc % 4 == 0 and hc >= hr
    assert nprog * steps >= tiles[0] * tiles[1] > nprog * (steps - 1)


def test_plan_rejects_a_block_smaller_than_its_halo():
    with pytest.raises(ValueError, match="too small"):
        hopper._plan((64, 64), "rbgs", 3, (8, 32), 8)


def test_zero_sweeps_is_identity():
    u = jnp.ones((8, 8), jnp.float32)
    assert hopper.smooth_pallas(u, u, 0.125, 0, "wjacobi",
                                interpret=True) is u


def test_wrapper_refuses_3d():
    u = jnp.ones((8, 8, 8), jnp.float32)
    with pytest.raises(ValueError, match="unsupported"):
        hopper.smooth_pallas(u, u, 0.125, 1, "wjacobi", interpret=True)


@pytest.mark.parametrize("shape,dtype", [((8, 8, 8), jnp.float32),
                                         ((16, 16), jnp.float64)])
def test_smooth_falls_back_to_xla(shape, dtype):
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(size=shape), dtype)
    f = jnp.asarray(rng.normal(size=shape), dtype)
    np.testing.assert_array_equal(
        np.asarray(hopper.smooth(u, f, 0.125, 2, "wjacobi", "face")),
        np.asarray(xla.smooth(u, f, 0.125, 2, "wjacobi", "face")))


def test_kernel_casts_f_and_keeps_u_dtype():
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.normal(size=(24, 40)), jnp.bfloat16)
    f = jnp.asarray(rng.normal(size=(24, 40)), jnp.float32)
    got = hopper.smooth_pallas(u, f, 1 / 24, 2, "wjacobi", "ghost0",
                               block=(16, 32), programs=3, interpret=True)
    assert got.shape == (24, 40) and got.dtype == jnp.bfloat16
    want = xla.smooth(u, f.astype(jnp.bfloat16), 1 / 24, 2, "wjacobi",
                      "ghost0")
    d = jnp.max(jnp.abs(got.astype(jnp.float32) - want.astype(jnp.float32)))
    assert float(d / jnp.max(jnp.abs(want.astype(jnp.float32)))) < 3e-2


def test_batched_kernel_under_vmap():
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.normal(size=(3, 32, 32)), jnp.float32)
    f = jnp.asarray(rng.normal(size=(3, 32, 32)), jnp.float32)
    got = jax.vmap(lambda a, b: hopper.smooth_pallas(
        a, b, 1 / 32, 2, "wjacobi", "face", block=(16, 32), programs=5,
        interpret=True))(u, f)
    want = jax.vmap(lambda a, b: xla.smooth(a, b, 1 / 32, 2, "wjacobi",
                                            "face"))(u, f)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_parity_sweep_runs_interpreted():
    from mgpoisson.bench.parity import run_parity
    out = run_parity(sizes=(64,), interpret=True, block=(32, 64))
    assert not out["failures"], out["failures"]
    assert out["n_cases"] > 0
    assert out["max_err_f32"] <= 1e-6
    assert out["max_err_bf16"] <= 3e-2


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu):
    from mgpoisson.bench.parity import run_parity
    out = run_parity(sizes=(1024,))
    assert not out["failures"], out["failures"]
    assert out["max_err_f32"] <= 1e-6
    assert out["max_err_bf16"] <= 3e-2


# ------------------------------------------------------ compile cache

@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_uses_the_environment(monkeypatch, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(compile_cache.ENV, "/somewhere/else")
    assert compile_cache.enable() == "/somewhere/else"
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_defaults_to_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    got = compile_cache.enable()
    assert got.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    import os
    import mgpoisson
    checkout = os.path.dirname(os.path.dirname(mgpoisson.__file__))
    assert os.path.dirname(got) == checkout


# --------------------------------------------------------- peak table

def test_peak_table_knows_the_h100():
    assert roofline.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_refuses_unknown_devices(kind):
    with pytest.raises(KeyError, match="no published peak"):
        roofline.hbm_peak_gbps(kind)
