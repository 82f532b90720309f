"""The nu-sweep smoother against the float64 oracle, for both
implementations: `xla.smooth` and the Hopper kernel
(`hopper.smooth_pallas`, run by the Pallas interpreter here).

Geometries are stated in tiles of the kernel's extended block: a grid
inside one tile's interior, a grid of exactly 2 x 2 whole tiles, and
a 256^2 grid of many tiles walked by a few persistent programs.  The
XLA cases run on the same grids."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from mgpoisson import oracle
from mgpoisson.kernels import hopper, xla

BLOCK = (32, 64)
SMOOTHERS = ["jacobi", "wjacobi", "rbgs"]
SWEEPS = {"jacobi": oracle.jacobi_sweep, "wjacobi": oracle.wjacobi_sweep,
          "rbgs": oracle.rbgs_sweep}
TOL = {"float32": 1e-6, "bfloat16": 3e-2}


def _shape(geometry, smoother, nu):
    hr, hc = hopper._halo(smoother, nu)
    tm, tn = BLOCK[0] - 2 * hr, BLOCK[1] - 2 * hc
    return {"subtile": (min(tm, 16), min(tn, 16)),
            "whole_tiles": (2 * tm, 2 * tn),
            "many_tiles": (256, 256)}[geometry]


def _run(impl, u, f, h, nu, smoother, bc):
    if impl == "xla":
        return xla.smooth(u, f, h, nu, smoother, bc)
    return hopper.smooth_pallas(u, f, h, nu, smoother, bc, block=BLOCK,
                                programs=5, interpret=True)


@pytest.mark.parametrize(
    "impl,smoother,bc,nu,dtype,geometry",
    list(itertools.product(["xla", "hopper"], SMOOTHERS,
                           ["ghost0", "face"], [1, 2, 3],
                           ["float32", "bfloat16"],
                           ["subtile", "whole_tiles", "many_tiles"])))
def test_smoother_matches_oracle(impl, smoother, bc, nu, dtype, geometry):
    shape = _shape(geometry, smoother, nu)
    rng = np.random.default_rng([SMOOTHERS.index(smoother), nu, len(bc)])
    u = rng.normal(size=shape)
    f = rng.normal(size=shape)
    h = 1.0 / shape[0]
    # the oracle starts from the values the device actually holds
    uj = jnp.asarray(u, dtype)
    fj = jnp.asarray(f, dtype)
    want = np.asarray(uj, np.float64)
    fo = np.asarray(fj, np.float64)
    for _ in range(nu):
        want = SWEEPS[smoother](want, fo, h, bc)
    got = _run(impl, uj, fj, h, nu, smoother, bc)
    assert got.shape == shape and got.dtype == jnp.dtype(dtype)
    d = np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(
        np.abs(want))
    assert d <= TOL[dtype], d
