"""Mixed-precision iterative refinement (Spec.sweep_dtype).

The V-cycle runs in sweep_dtype on the error equation A e = r while the
residual, correction, and stopping metric stay in dtype — bf16 sweeps
with f32-accurate answers.  The dtype axis is an explicit behavioral
surface of the reference (fp64-preferring device pick, `gpu.lua:7-15,32`);
refinement is its extension: bf16 is the bandwidth-fast
storage format, but a pure-bf16 solve stalls at ~3 decimal digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mgpoisson import MultigridPoisson, Spec
from mgpoisson.kernels import xla as xla_ops


def _rel_residual(psi, f, h):
    return float(xla_ops.residual_norm(psi, f, h)
                 / jnp.linalg.norm(f.astype(jnp.float32)))


def test_bf16_sweeps_reach_f32_accuracy():
    spec = Spec(size=128, dtype="float32", sweep_dtype="bfloat16",
                scheme="tuned", backend="xla", stop="residual",
                tol=1e-8, maxiter=60)
    mg = MultigridPoisson(spec)
    f = mg.rhs()
    res = mg.solve(f)
    assert res.converged
    # the refinement loop must land far below the ~1e-2 bf16 kernel
    # floor: f32-level accuracy from bf16 sweeps
    r0 = float(xla_ops.residual_norm(mg.init_state(f), f, spec.fine_h))
    rel = float(xla_ops.residual_norm(res.psi, f, spec.fine_h)) / r0
    assert rel < 1e-7
    assert res.psi.dtype == jnp.float32


def test_refinement_cycle_count_close_to_f32():
    # bf16 inner cycles contract slower than f32 (~0.17 vs ~0.10 per
    # cycle at size 128) but must stay the same order of magnitude
    kw = dict(size=128, dtype="float32", scheme="tuned", backend="xla",
              stop="residual", tol=1e-8, maxiter=60)
    it_f32 = MultigridPoisson(Spec(**kw)).solve().iterations
    it_mix = MultigridPoisson(
        Spec(sweep_dtype="bfloat16", **kw)).solve().iterations
    assert it_mix <= 2 * it_f32 + 2


def test_sweep_dtype_equal_dtype_is_plain_path():
    kw = dict(size=64, dtype="float32", scheme="tuned", backend="xla",
              stop="residual", tol=1e-8, maxiter=40)
    r_plain = MultigridPoisson(Spec(**kw)).solve()
    r_same = MultigridPoisson(Spec(sweep_dtype="float32", **kw)).solve()
    assert r_same.iterations == r_plain.iterations
    np.testing.assert_array_equal(np.asarray(r_same.psi),
                                  np.asarray(r_plain.psi))


def test_update_stop_and_3d():
    spec = Spec(size=32, ndim=3, dtype="float32", sweep_dtype="bfloat16",
                scheme="tuned", backend="xla", stop="update",
                tol=1e-6, maxiter=80)
    mg = MultigridPoisson(spec)
    f = mg.rhs()
    res = mg.solve(f)
    assert res.converged
    assert _rel_residual(res.psi, f, spec.fine_h) < 1e-4


def test_refinement_under_gspmd_mesh():
    # refinement composes with the GSPMD partition (constrain is jnp-
    # level); sharded == unsharded to tolerance
    spec = Spec(size=64, dtype="float32", sweep_dtype="bfloat16",
                scheme="tuned", backend="xla", stop="residual",
                tol=1e-8, maxiter=60)
    res1 = MultigridPoisson(spec).solve()
    res2 = MultigridPoisson(
        spec.with_(mesh_shape=(2, 2), partition="gspmd")).solve()
    assert res2.converged
    d = float(jnp.max(jnp.abs(res1.psi - res2.psi))
              / jnp.max(jnp.abs(res1.psi)))
    assert d < 1e-5


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_refinement_under_spmd_partition(mesh_shape):
    # sweep_dtype refinement under the explicit shard_map partition:
    # the bf16 error-equation V-cycle runs
    # shard-locally with deep-halo ppermute exchange; residual /
    # correction / metric stay f32.  Matches the single-device mixed
    # solve to refinement tolerance.
    spec = Spec(size=64, dtype="float32", sweep_dtype="bfloat16",
                scheme="tuned", backend="xla", stop="residual",
                tol=1e-8, maxiter=60)
    res1 = MultigridPoisson(spec).solve()
    resN = MultigridPoisson(
        spec.with_(mesh_shape=mesh_shape, partition="spmd",
                   replicate_below=8)).solve()
    assert resN.converged
    d = float(jnp.max(jnp.abs(res1.psi - resN.psi))
              / jnp.max(jnp.abs(res1.psi)))
    assert d < 1e-5


def test_refinement_spmd_update_stop():
    # the update-RMS metric path of the spmd mixed step.  The update IS
    # the bf16 correction, so it floors near bf16 eps times the iterate
    # scale (~1e-5 here) — tol must sit above that floor.
    spec = Spec(size=64, dtype="float32", sweep_dtype="bfloat16",
                scheme="tuned", backend="xla", stop="update",
                tol=2e-5, maxiter=60, mesh_shape=(2, 2),
                partition="spmd", replicate_below=8)
    res = MultigridPoisson(spec).solve()
    assert res.converged
    f = MultigridPoisson(spec).rhs()
    assert _rel_residual(res.psi, f, spec.fine_h) < 1e-3


def test_bad_sweep_dtype_rejected():
    with pytest.raises(ValueError, match="sweep_dtype"):
        Spec(size=64, sweep_dtype="float16")
