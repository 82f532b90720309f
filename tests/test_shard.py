"""Sharded-execution tests on 8 virtual CPU devices (set in conftest via
xla_force_host_platform_device_count — SURVEY.md section 4 'multi-device
without a cluster').  Gate: sharded == single-device results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgpoisson import MultigridPoisson, Spec
from mgpoisson.shard.gspmd import level_partition_spec
from mgpoisson.shard.mesh import build_mesh, mesh_shape_for


def test_mesh_shape_factorization():
    assert mesh_shape_for(8) == (4, 2)
    assert mesh_shape_for(4) == (2, 2)
    assert mesh_shape_for(16) == (4, 4)
    assert mesh_shape_for(1) == (1, 1)


def test_build_mesh_8_devices():
    mesh = build_mesh((4, 2))
    assert mesh.shape == {"x": 4, "y": 2}


def test_level_partition_spec_policy():
    mesh = build_mesh((4, 2))
    ps_fine = level_partition_spec(256, 2, mesh, replicate_below=16)
    assert tuple(ps_fine) == ("x", "y")
    ps_coarse = level_partition_spec(8, 2, mesh, replicate_below=16)
    assert tuple(ps_coarse) == (None, None)
    # 3D: only the first two axes shard
    ps_3d = level_partition_spec(64, 3, mesh, replicate_below=16)
    assert tuple(ps_3d) == ("x", "y", None)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 2), (8, 1)])
def test_sharded_step_matches_single_device(mesh_shape):
    spec1 = Spec(size=64, dtype="float64", backend="xla", scheme="tuned")
    specN = spec1.with_(mesh_shape=mesh_shape, partition="gspmd",
                        replicate_below=8)
    mg1 = MultigridPoisson(spec1)
    mgN = MultigridPoisson(specN)

    f = mg1.rhs()
    psi = mg1.init_state(f)
    psi1, err1 = mg1.step(psi, f)
    psiN, errN = mgN.step(psi, f)
    np.testing.assert_allclose(np.asarray(psiN), np.asarray(psi1),
                               rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(float(errN), float(err1), rtol=1e-12)


def test_sharded_solve_matches_single_device():
    spec1 = Spec(size=64, dtype="float64", backend="xla", scheme="tuned",
                 stop="residual", tol=1e-10)
    specN = spec1.with_(mesh_shape=(4, 2), partition="gspmd",
                        replicate_below=8)
    res1 = MultigridPoisson(spec1).solve()
    resN = MultigridPoisson(specN).solve()
    assert res1.iterations == resN.iterations
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-10, atol=1e-8)


def test_sharded_reference_scheme_matches():
    spec1 = Spec(size=32, dtype="float64", backend="xla", scheme="reference",
                 maxiter=5)
    specN = spec1.with_(mesh_shape=(2, 2), partition="gspmd",
                        replicate_below=8)
    res1 = MultigridPoisson(spec1).solve()
    resN = MultigridPoisson(specN).solve()
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-11, atol=1e-9)


def test_sharded_3d():
    spec1 = Spec(size=32, ndim=3, dtype="float64", backend="xla",
                 scheme="tuned", maxiter=3)
    specN = spec1.with_(mesh_shape=(2, 2), partition="gspmd",
                        replicate_below=8)
    res1 = MultigridPoisson(spec1).solve()
    resN = MultigridPoisson(specN).solve()
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-11, atol=1e-9)


def test_fine_level_actually_sharded():
    # the fine-level psi produced by a sharded step carries the 2D layout
    spec = Spec(size=64, dtype="float64", backend="xla", scheme="tuned",
                mesh_shape=(4, 2), replicate_below=8)
    mg = MultigridPoisson(spec)
    f = mg.rhs()
    psi, _ = mg.step(mg.init_state(f), f)
    shardings = {tuple(s.data.shape) for s in psi.addressable_shards}
    assert shardings == {(16, 32)}  # 64/4 x 64/2


# ---------------------------------------------------------------- spmd path

@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 2), (8, 1)])
@pytest.mark.parametrize("scheme", ["tuned", "reference"])
def test_spmd_step_matches_single_device(mesh_shape, scheme):
    spec1 = Spec(size=64, dtype="float64", backend="xla", scheme=scheme)
    specN = spec1.with_(mesh_shape=mesh_shape, partition="spmd",
                        replicate_below=8)
    mg1 = MultigridPoisson(spec1)
    mgN = MultigridPoisson(specN)
    f = mg1.rhs()
    psi = mg1.init_state(f)
    psi1, err1 = mg1.step(psi, f)
    psiN, errN = mgN.step(psi, f)
    np.testing.assert_allclose(np.asarray(psiN), np.asarray(psi1),
                               rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(float(errN), float(err1), rtol=1e-12)


def test_spmd_solve_matches_gspmd():
    base = Spec(size=64, dtype="float64", backend="xla", scheme="tuned",
                stop="residual", tol=1e-10, replicate_below=8,
                mesh_shape=(4, 2))
    res_g = MultigridPoisson(base).solve()
    res_s = MultigridPoisson(base.with_(partition="spmd")).solve()
    assert res_g.iterations == res_s.iterations
    np.testing.assert_allclose(np.asarray(res_s.psi), np.asarray(res_g.psi),
                               rtol=1e-10, atol=1e-8)


def test_spmd_3d_matches_single_device():
    spec1 = Spec(size=32, ndim=3, dtype="float64", backend="xla",
                 scheme="tuned", maxiter=3)
    specN = spec1.with_(mesh_shape=(4, 2), partition="spmd",
                        replicate_below=8)
    res1 = MultigridPoisson(spec1).solve()
    resN = MultigridPoisson(specN).solve()
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-11, atol=1e-9)
    shardings = {tuple(s.data.shape) for s in resN.psi.addressable_shards}
    assert shardings == {(8, 16, 32)}


def test_spmd_wcycle_matches_single_device():
    spec1 = Spec(size=64, dtype="float64", backend="xla", scheme="tuned",
                 cycle="w", maxiter=3)
    specN = spec1.with_(mesh_shape=(2, 2), partition="spmd",
                        replicate_below=8)
    res1 = MultigridPoisson(spec1).solve()
    resN = MultigridPoisson(specN).solve()
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-11, atol=1e-9)


@pytest.mark.parametrize("scheme", ["tuned", "reference"])
def test_spmd_fmg_matches_unsharded(scheme):
    # FMG under the explicit partition: the sharded FMG initializer and
    # the subsequent sharded solve must match the single-device FMG path
    spec1 = Spec(size=64, dtype="float64", scheme=scheme, cycle="fmg",
                 backend="xla", maxiter=6)
    specN = spec1.with_(mesh_shape=(2, 2), partition="spmd",
                        replicate_below=8)
    mg1 = MultigridPoisson(spec1)
    mgN = MultigridPoisson(specN)
    f = mg1.rhs()

    u0_1 = mg1.init_state(f)
    u0_N = mgN.init_state(f)
    np.testing.assert_allclose(np.asarray(u0_N), np.asarray(u0_1),
                               rtol=1e-11, atol=1e-9)

    res1 = mg1.solve(f)
    resN = mgN.solve(f)
    assert resN.iterations == res1.iterations
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-11, atol=1e-9)


def test_mesh_fences_pallas_backend(monkeypatch):
    # GSPMD cannot partition a pallas_call, and shard/spmd.py runs its
    # own per-shard XLA sweeps: under a mesh get_ops returns the XLA ops
    # for every level, even on a GPU and with backend='pallas'
    import mgpoisson.kernels as K

    monkeypatch.setattr(K, "on_gpu", lambda: True)
    for backend in ("auto", "pallas"):
        spec = Spec(size=8192, backend=backend, mesh_shape=(4, 2),
                    pallas_min_size=64)
        assert K.get_ops(spec, 8192) is K.xla
        assert K.get_ops(spec.with_(mesh_shape=None), 8192) is not K.xla

    # and a solver constructed with an explicit mesh normalizes
    # spec.mesh_shape so the fence applies
    from mgpoisson.shard.mesh import build_mesh
    mg = MultigridPoisson(Spec(size=64, backend="auto"),
                          mesh=build_mesh((4, 2)))
    assert mg.spec.mesh_shape == (4, 2)


def test_default_partition_resolution():
    """partition='auto' (the default) dispatches a meshed solver to the
    explicit spmd partition and falls back to gspmd when there is no
    ('x','y') mesh to address."""
    mg = MultigridPoisson(Spec(size=64, dtype="float64", backend="xla",
                               mesh_shape=(2, 2), replicate_below=8))
    assert mg.partition == "spmd"
    assert MultigridPoisson(Spec(size=32, backend="xla")).partition == "gspmd"
    # a mesh without the ('x','y') axes cannot be addressed by the
    # spmd collectives: fall back to gspmd layout constraints
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    mg2 = MultigridPoisson(Spec(size=32, backend="xla"), mesh)
    assert mg2.partition == "gspmd"
    # explicit choices are honored verbatim
    mg3 = MultigridPoisson(Spec(size=64, dtype="float64", backend="xla",
                                mesh_shape=(2, 2), partition="gspmd"))
    assert mg3.partition == "gspmd"


def test_default_partition_solve_matches_single_device():
    # a defaults-only meshed solve (auto -> spmd) == single device
    spec1 = Spec(size=64, dtype="float64", backend="xla", scheme="tuned",
                 stop="residual", tol=1e-10)
    res1 = MultigridPoisson(spec1).solve()
    resN = MultigridPoisson(
        spec1.with_(mesh_shape=(4, 2), replicate_below=8)).solve()
    assert res1.iterations == resN.iterations
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-10, atol=1e-8)


def test_adaptive_stop_check_under_spmd():
    """stop_check='adaptive' under the explicit partition: same converged iterate and cycle count as 'every', with
    fewer metric evaluations (skipped cycles run the metric-free
    shard_map cycle)."""
    kw = dict(size=64, dtype="float64", backend="xla", scheme="tuned",
              stop="residual", tol=1e-10, mesh_shape=(2, 2),
              partition="spmd", replicate_below=8)
    res_e = MultigridPoisson(Spec(**kw)).solve()
    res_a = MultigridPoisson(Spec(stop_check="adaptive", **kw)).solve()
    assert res_a.converged
    assert res_a.iterations == res_e.iterations
    assert res_a.n_metric_evals < res_a.iterations
    np.testing.assert_allclose(np.asarray(res_a.psi),
                               np.asarray(res_e.psi), rtol=1e-12)
    np.testing.assert_allclose(float(res_a.errs[-1]),
                               float(res_e.errs[-1]), rtol=1e-10)


def test_spmd_fmg_small_grid_replicated_finest():
    """cycle='fmg' + partition='spmd' with the FINEST level at or below
    replicate_below: fmg_local runs the whole hierarchy replicated and
    must slice its full-grid result back to the local block."""
    spec1 = Spec(size=32, dtype="float64", scheme="tuned", cycle="fmg",
                 backend="xla", maxiter=6)
    specN = spec1.with_(mesh_shape=(2, 2), partition="spmd",
                        replicate_below=64)
    mg1 = MultigridPoisson(spec1)
    mgN = MultigridPoisson(specN)
    f = mg1.rhs()
    u0_1 = mg1.init_state(f)
    u0_N = mgN.init_state(f)
    assert u0_N.shape == u0_1.shape
    np.testing.assert_allclose(np.asarray(u0_N), np.asarray(u0_1),
                               rtol=1e-11, atol=1e-9)
    res1 = mg1.solve(f)
    resN = mgN.solve(f)
    np.testing.assert_allclose(np.asarray(resN.psi), np.asarray(res1.psi),
                               rtol=1e-11, atol=1e-9)


def test_gspmd_fmg_constrained_layout():
    """FMG under a gspmd mesh runs WITH per-level layout constraints:
    the initial iterate comes out in the fine
    level's block layout and matches the unconstrained value."""
    spec1 = Spec(size=64, dtype="float64", scheme="tuned", cycle="fmg",
                 backend="xla", maxiter=6)
    specN = spec1.with_(mesh_shape=(4, 2), partition="gspmd",
                        replicate_below=8)
    mg1 = MultigridPoisson(spec1)
    mgN = MultigridPoisson(specN)
    f = mg1.rhs()
    u0_N = mgN.init_state(f)
    np.testing.assert_allclose(np.asarray(u0_N),
                               np.asarray(mg1.init_state(f)),
                               rtol=1e-12, atol=1e-11)
    # the FMG output carries the fine level's 2D block sharding, proof
    # the constraint reached the pass (unconstrained FMG lets XLA pick)
    shardings = {tuple(s.data.shape) for s in u0_N.addressable_shards}
    assert shardings == {(16, 32)}
