"""Debug subsystem, checkpoint/resume, and FMG solve-mode tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from mgpoisson import MultigridPoisson, Spec, oracle
from mgpoisson.utils import (check_finite, compare_traces, dump_trace,
                             load_state, save_state, validate_cycle)
from mgpoisson.utils.checkpoint import resume_solve
from mgpoisson.utils.debug import NonFiniteError


def _spec(**kw):
    base = dict(size=32, dtype="float64", backend="xla", scheme="tuned")
    base.update(kw)
    return Spec(**base)


def test_check_finite_raises_with_stage_name():
    bad = np.array([[1.0, np.nan]])
    with pytest.raises(NonFiniteError, match="found a nan.*'r'.*level size 8"):
        check_finite("r", bad, 8)


def test_validate_cycle_clean_run():
    spec = _spec()
    f = jnp.asarray(oracle.point_charge_rhs(32))
    u, trace = validate_cycle(spec, -f, f)
    assert any(name == "R" for name, _, _ in trace)
    check_finite("u", u)


def test_validate_cycle_catches_poison():
    spec = _spec()
    f = jnp.asarray(oracle.point_charge_rhs(32)).at[0, 0].set(jnp.inf)
    with pytest.raises(NonFiniteError):
        validate_cycle(spec, -f, f)


def test_compare_traces_cross_implementation():
    # the reference's debug-dump diff: JAX trace vs oracle trace
    spec = _spec()
    f64 = oracle.point_charge_rhs(32)
    jtrace = []
    from mgpoisson.cycle.vcycle import v_cycle
    v_cycle(jnp.asarray(-f64), jnp.asarray(f64), spec.fine_h, spec,
            trace=jtrace)
    otrace = []
    oracle.v_cycle(-f64, f64, spec.fine_h, pre_smooth=spec.nu_pre,
                   post_smooth=spec.nu_post, smoother=spec.smoother_resolved,
                   scheme=spec.scheme, trace=otrace)
    report = compare_traces(jtrace, otrace, rtol=1e-9, atol=1e-9)
    assert all(r["ok"] for r in report), [r for r in report if not r["ok"]]


def test_compare_traces_structure_mismatch():
    t1 = [("u", 4, np.zeros((4, 4)))]
    t2 = [("r", 4, np.zeros((4, 4)))]
    with pytest.raises(ValueError, match="structures differ"):
        compare_traces(t1, t2)


def test_dump_trace_reference_format(capsys):
    trace = [("u", 2, np.array([[1.0, 2.0], [3.0, 4.0]]))]
    dump_trace(trace)
    out = capsys.readouterr().out
    assert "L 2" in out and "u" in out and "1 2" in out


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "state.npz")
    psi = np.arange(16.0).reshape(4, 4)
    f = np.ones((4, 4))
    save_state(path, psi, f=f, iteration=7, errs=[1.0, 0.5],
               meta={"size": 4})
    state = load_state(path)
    np.testing.assert_array_equal(state["psi"], psi)
    np.testing.assert_array_equal(state["f"], f)
    assert state["iteration"] == 7
    assert state["meta_size"] == 4


def test_checkpoint_resume_continues_solve(tmp_path):
    spec = _spec(stop="residual", tol=1e-10)
    mg = MultigridPoisson(spec)
    f = mg.rhs()
    # run 2 cycles, checkpoint, resume — must match an uninterrupted solve
    psi = mg.init_state(f)
    for _ in range(2):
        psi, _ = mg.step(psi, f)
    path = str(tmp_path / "ck.npz")
    save_state(path, np.asarray(psi), f=np.asarray(f), iteration=2)
    res_resumed = resume_solve(mg, path)
    res_full = MultigridPoisson(spec).solve()
    # note: stop='residual' normalizes by r0 of the *starting* iterate,
    # so the resumed solve's stopping point differs; both must land on
    # the same discrete solution to solver tolerance
    assert res_resumed.converged and res_full.converged
    a, b = np.asarray(res_resumed.psi), np.asarray(res_full.psi)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-6


def test_fmg_solve_mode_faster_start():
    # FMG initialization lands orders of magnitude closer than psi0=-f
    # (absolute residual; the relative 'residual' stop re-normalizes by
    # the better r0, so iteration counts are not comparable directly)
    spec_v = _spec(stop="residual", tol=1e-10, size=64)
    spec_f = spec_v.with_(cycle="fmg")
    mg_v = MultigridPoisson(spec_v)
    mg_f = MultigridPoisson(spec_f)
    f = mg_v.rhs()
    r_plain = float(mg_v.residual_norm(mg_v.init_state(f), f))
    r_fmg = float(mg_f.residual_norm(mg_f.init_state(f), f))
    assert r_fmg < r_plain * 1e-3
    res_v = MultigridPoisson(spec_v).solve()
    res_f = MultigridPoisson(spec_f).solve()
    assert res_f.converged
    a, b = np.asarray(res_f.psi), np.asarray(res_v.psi)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-6


def test_checkpoint_sharded_roundtrip(tmp_path):
    # the multi-host layout (per-process shard files) exercised single-host by forcing sharded=True under a
    # (4, 2) mesh: save only addressable shards + index offsets,
    # stitch the local block back, reassemble on the mesh
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mgpoisson.shard.mesh import build_mesh

    mesh = build_mesh((4, 2))
    size = 32
    spec = Spec(size=size, dtype="float32", scheme="tuned",
                backend="xla", mesh_shape=(4, 2), partition="spmd",
                maxiter=3)
    mg = MultigridPoisson(spec, mesh=mesh)
    f = jax.device_put(mg.rhs(), NamedSharding(mesh, P("x", "y")))
    psi, _ = mg.step(-f, f)

    path = str(tmp_path / "ck_sharded")
    save_state(path, psi, f=f, iteration=1, errs=[2.0], sharded=True)
    import os
    assert os.path.exists(path + ".proc0.npz")
    assert not os.path.exists(path)          # no single-file fallback

    # load WITHOUT a mesh: local numpy block (here: the whole grid,
    # single process owns everything)
    state_np = load_state(path)
    np.testing.assert_array_equal(state_np["psi"], np.asarray(psi))
    assert state_np["iteration"] == 1

    # load WITH the mesh: global jax.Arrays with the solver's layout
    state = load_state(path, mesh=mesh)
    assert state["psi"].shape == (size, size)
    np.testing.assert_array_equal(np.asarray(state["psi"]),
                                  np.asarray(psi))
    np.testing.assert_array_equal(np.asarray(state["f"]), np.asarray(f))

    # resume_solve consumes the sharded checkpoint directly
    res = resume_solve(mg, path)
    assert np.isfinite(res.final_err)
