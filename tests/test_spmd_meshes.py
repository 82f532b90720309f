"""partition='spmd' (shard_map with deep-halo ppermute exchange, every
per-shard op XLA's) against the single-device step, over row-, column-
and block-sharded meshes of the 8 virtual CPU devices, in 2D and 3D,
for every parallel smoother, plus the mixed bf16/f32 refinement step."""

import itertools

import numpy as np
import pytest

from mgpoisson import MultigridPoisson, Spec
from mgpoisson.shard.mesh import build_mesh

MESHES = [(1, 2), (2, 1), (2, 2), (4, 2)]


def _step_pair(spec, mesh_shape):
    mg1 = MultigridPoisson(spec)
    mgN = MultigridPoisson(spec.with_(mesh_shape=mesh_shape,
                                      partition="spmd"),
                           mesh=build_mesh(mesh_shape))
    f = mg1.rhs()
    psi = mg1.init_state(f)
    (p1, e1), (pN, eN) = mg1.step(psi, f), mgN.step(psi, f)
    nshards = len({s.device for s in pN.addressable_shards})
    assert nshards == mesh_shape[0] * mesh_shape[1]
    return np.asarray(p1, np.float64), np.asarray(pN, np.float64), \
        float(e1), float(eN)


@pytest.mark.parametrize("mesh_shape,ndim,smoother", list(itertools.product(
    MESHES, [2, 3], ["jacobi", "wjacobi", "rbgs"])), ids=str)
def test_spmd_step_matches_single_device(mesh_shape, ndim, smoother):
    spec = Spec(size=32 if ndim == 2 else 16, ndim=ndim, dtype="float64",
                backend="xla", scheme="tuned", smoother=smoother,
                pre_smooth=2, post_smooth=2, stop="residual",
                replicate_below=4)
    p1, pN, e1, eN = _step_pair(spec, mesh_shape)
    np.testing.assert_allclose(pN, p1, rtol=1e-11,
                               atol=1e-11 * np.abs(p1).max())
    np.testing.assert_allclose(eN, e1, rtol=1e-10)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2)], ids=str)
def test_spmd_mixed_bf16_step_matches_single_device(mesh_shape):
    spec = Spec(size=64, dtype="float32", sweep_dtype="bfloat16",
                backend="xla", scheme="tuned", stop="residual",
                replicate_below=8)
    p1, pN, e1, eN = _step_pair(spec, mesh_shape)
    # the residual and the metric are f32 on both paths; the correction
    # is a bf16 V-cycle whose sums run in another order per shard
    assert np.max(np.abs(pN - p1)) / np.abs(p1).max() < 3e-2
    np.testing.assert_allclose(eN, e1, rtol=1e-5)
