"""Functional-transform capabilities: the V-cycle is a pure jittable
function, so batching (vmap) and differentiation (grad/jvp) compose
with it for free — capabilities the reference's imperative buffers
could never express."""

import jax
import jax.numpy as jnp
import numpy as np

from mgpoisson import MultigridPoisson, Spec, oracle
from mgpoisson.cycle.vcycle import v_cycle


def _spec(**kw):
    base = dict(size=32, dtype="float64", backend="xla", scheme="tuned")
    base.update(kw)
    return Spec(**base)


def test_vmap_batched_rhs():
    # one compiled V-cycle sweep over a batch of right-hand sides
    spec = _spec()
    rng = np.random.default_rng(0)
    fs = jnp.asarray(rng.normal(size=(4, 32, 32)))
    step = jax.vmap(lambda u, f: v_cycle(u, f, spec.fine_h, spec))
    us = -fs
    for _ in range(16):
        us = step(us, fs)
    from mgpoisson.kernels import xla
    for k in range(4):
        rel = float(xla.residual_norm(us[k], fs[k], spec.fine_h)) / float(
            jnp.sqrt(jnp.sum(fs[k] ** 2)))
        assert rel < 1e-6, f"batch element {k}: {rel:.2e}"
    # matches the unbatched solve
    single = -fs[1]
    for _ in range(16):
        single = v_cycle(single, fs[1], spec.fine_h, spec)
    np.testing.assert_allclose(np.asarray(us[1]), np.asarray(single),
                               rtol=1e-12, atol=1e-12)


def test_grad_flows_through_cycles():
    # d(loss)/d(f) through k V-cycles: the solver is differentiable,
    # so it can sit inside optimization / learned-correction loops
    spec = _spec(size=16)
    f0 = jnp.asarray(oracle.point_charge_rhs(16))

    def loss(f):
        u = -f
        for _ in range(3):
            u = v_cycle(u, f, spec.fine_h, spec)
        return jnp.sum(u ** 2)

    g = jax.grad(loss)(f0)
    assert np.isfinite(np.asarray(g)).all()
    # check against finite differences at one cell
    eps = 1e-3
    e = jnp.zeros_like(f0).at[3, 4].set(eps)
    fd = (loss(f0 + e) - loss(f0 - e)) / (2 * eps)
    np.testing.assert_allclose(float(g[3, 4]), float(fd), rtol=1e-5)


def test_grad_linearity_property():
    # the k-cycle map f -> u is LINEAR in f (fixed psi0 = -f is linear
    # too), so u(a*f) == a*u(f)
    spec = _spec(size=16)
    f0 = jnp.asarray(oracle.point_charge_rhs(16))

    def run(f):
        u = -f
        for _ in range(2):
            u = v_cycle(u, f, spec.fine_h, spec)
        return u

    u1 = run(f0)
    u2 = run(2.5 * f0)
    np.testing.assert_allclose(np.asarray(u2), 2.5 * np.asarray(u1),
                               rtol=1e-12)


def test_jvp_matches_linear_operator():
    spec = _spec(size=16)
    f0 = jnp.asarray(oracle.point_charge_rhs(16))
    df = jnp.ones_like(f0)

    def run(f):
        u = -f
        for _ in range(2):
            u = v_cycle(u, f, spec.fine_h, spec)
        return u

    _, tangent = jax.jvp(run, (f0,), (df,))
    # linear map: jvp == run(df)
    np.testing.assert_allclose(np.asarray(tangent), np.asarray(run(df)),
                               rtol=1e-10, atol=1e-12)


def test_solve_batched_api():
    spec = _spec(size=32, stop="residual", tol=1e-9)
    mg = MultigridPoisson(spec)
    rng = np.random.default_rng(1)
    fs = jnp.asarray(rng.normal(size=(3, 32, 32)))
    psis, errs = mg.solve_batched(fs)
    assert psis.shape == (3, 32, 32)
    assert float(jnp.max(errs)) < 1e-9
    # agrees with per-element solves
    for k in range(3):
        res = mg.solve(fs[k])
        np.testing.assert_allclose(np.asarray(psis[k]), np.asarray(res.psi),
                                   rtol=1e-8, atol=1e-8)


def test_solve_batched_fixed_cycles():
    spec = _spec(size=16)
    mg = MultigridPoisson(spec)
    fs = jnp.stack([jnp.asarray(oracle.point_charge_rhs(16))] * 2)
    psis, errs = mg.solve_batched(fs, cycles=4)
    np.testing.assert_allclose(np.asarray(psis[0]), np.asarray(psis[1]))
    assert errs.shape == (2,)


def test_solve_batched_freezes_converged_elements():
    """Until-converged batching freezes per-element once below tol: an
    easy element's iterate must be bit-stable
    while a hard element keeps cycling, and results match per-element
    solves."""
    # the update-RMS metric is absolute, so a tiny-amplitude copy of
    # the same problem converges in far fewer cycles — a genuinely
    # mixed-difficulty batch
    spec = _spec(size=32, stop="update", tol=1e-9, maxiter=60)
    mg = MultigridPoisson(spec)
    rng = np.random.default_rng(7)
    f_hard = jnp.asarray(rng.normal(size=(32, 32)))
    f_easy = 1e-6 * f_hard
    fs = jnp.stack([f_easy, f_hard])
    psis, errs = mg.solve_batched(fs)
    assert float(jnp.max(errs)) < 1e-9
    res_easy = mg.solve(f_easy)
    res_hard = mg.solve(f_hard)
    assert res_easy.iterations < res_hard.iterations
    # the easy element froze at its first converged iterate: identical
    # bits to its standalone solve (which stops at the same cycle);
    # without the freeze it would keep being smoothed for the hard
    # element's remaining cycles
    np.testing.assert_array_equal(np.asarray(psis[0]),
                                  np.asarray(res_easy.psi))
    # the hard element is unaffected by the freeze machinery
    np.testing.assert_allclose(np.asarray(psis[1]), np.asarray(res_hard.psi),
                               rtol=1e-8, atol=1e-8)
