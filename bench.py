#!/usr/bin/env python
"""Benchmark harness: prints ONE compact JSON line and writes the full
measurement set to BENCH_extras.json.

Headline: ONE smoother sweep's HBM round trip, (read u + read f + write
u) = 3 arrays divided by device time, with its fraction of the card's
HBM peak (mgpoisson/bench/roofline.py, keyed by device_kind).

Sections run headline-first, each guarded: an exception inside one is
recorded as `<name>_error`, and MGPOISSON_BENCH_DEADLINE (seconds,
default 1150) skips the sections that would start after the budget is
spent.  Progress goes to stderr; stdout is exactly one JSON line.

It measures the GPU.  With no GPU it exits non-zero, unless
JAX_PLATFORMS=cpu asks for a CPU rehearsal at toy sizes, whose numbers
are CPU numbers and carry no device metric.

Timing: chained applications inside one jit (lax.scan) at two lengths;
the difference cancels fixed dispatch overhead (mgpoisson/bench/timing).

This is the rebuild of the reference's wall-time harness
(`test/test.lua:44-76`); kernel-level GB/s replaces its TODO'd OpenCL
event timing (`test/test-gpu-obj.lua:268`).
"""

from __future__ import annotations

import functools
import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp

from mgpoisson.bench.roofline import hbm_peak_gbps
from mgpoisson.bench.timing import chain_time, sync as _sync
from mgpoisson.utils import compile_cache

FINAL_LINE_BUDGET = 1800
EXTRAS_PATH = os.environ.get(
    "MGPOISSON_BENCH_EXTRAS",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_extras.json"))

_T0 = time.monotonic()
_DEADLINE = float(os.environ.get("MGPOISSON_BENCH_DEADLINE", "1150"))

# everything measured; the final line carries a tracked subset
EXTRAS: dict = {}
# keys (in EXTRAS) promoted to the final line, in drop-last priority
# order: if the line overflows the budget, keys are dropped from the
# END of this list first
TRACKED_KEYS = [
    "platform", "device_kind", "size", "vcycle_time_ms",
    "vcycles_to_1e-10_relres", "vcycles_to_1e-10_rbgs",
    "config5_16384", "solve_wall_s", "fast_scheme_cycles_to_1e-10",
    "fast_scheme_solve_compute_ms", "spmd_vs_unsharded_vcycle",
    "kernel_parity_max_err", "kernel_parity_n_cases",
    "kernel_parity_failures",
    "vcycle_rnorm_time_ms", "fmg_vcycles_to_1e-10",
    "smoother", "nu", "sections_done", "sections_skipped",
    "hbm_peak_gbps", "extras_file", "elapsed_s",
]


def _elapsed() -> float:
    return time.monotonic() - _T0


def _remaining() -> float:
    return _DEADLINE - _elapsed()


def _log(msg: str) -> None:
    print(f"[bench +{_elapsed():7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _strict(x):
    """Strict-JSON-safe copy: non-finite floats (a diverged bf16 solve
    yields an inf residual) become strings — `json.dumps` would emit
    bare `Infinity`/`NaN`, which strict parsers reject."""
    if isinstance(x, dict):
        return {k: _strict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_strict(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def _write_extras() -> None:
    with open(EXTRAS_PATH, "w") as fh:
        json.dump(_strict({"deadline_s": _DEADLINE,
                           "elapsed_s": round(_elapsed(), 1),
                           **EXTRAS}), fh, indent=1, allow_nan=False)
        fh.write("\n")


def _emit_final(note: str | None = None) -> None:
    """Print THE one stdout JSON line, <= budget chars."""
    EXTRAS["elapsed_s"] = round(_elapsed(), 1)
    EXTRAS["extras_file"] = os.path.basename(EXTRAS_PATH)
    if note:
        EXTRAS["note"] = note
    _write_extras()
    size = EXTRAS.get("size")
    gbps = EXTRAS.get("smoother_roundtrip_gbps")
    peak = EXTRAS.get("hbm_peak_gbps")
    out = {
        "metric": f"smoother_hbm_roundtrip_gbps_{size}x{size}_f32",
        "value": None if gbps is None else round(gbps, 2),
        "unit": "GB/s",
        "fraction_of_hbm_peak": (None if gbps is None or not peak
                                 else round(gbps / peak, 4)),
    }
    if note:
        out["note"] = note[:160]
    keys = list(TRACKED_KEYS)
    while True:
        out["extra"] = {k: EXTRAS[k] for k in keys if k in EXTRAS}
        line = json.dumps(_strict(out), allow_nan=False,
                          separators=(",", ":"))
        if len(line) <= FINAL_LINE_BUDGET or not keys:
            break
        keys.pop()               # drop lowest-priority key and retry
    print(line, flush=True)
    _log(f"final line emitted ({len(line)} chars)")


def _section(name: str, min_budget_s: float, fn, S: dict) -> None:
    """Run one guarded section: skipped when the remaining deadline
    budget is below its cost estimate; an exception inside it is
    recorded as `<name>_error` instead of killing the harness."""
    done = EXTRAS.setdefault("sections_done", [])
    skipped = EXTRAS.setdefault("sections_skipped", [])
    if _remaining() < min_budget_s:
        _log(f"section {name}: SKIPPED "
             f"(remaining {_remaining():.0f}s < {min_budget_s:.0f}s)")
        skipped.append(name)
        return
    _log(f"section {name}: start (remaining {_remaining():.0f}s)")
    try:
        fn(S)
        done.append(name)
        _log(f"section {name}: done")
    except Exception as e:  # noqa: BLE001 - recorded, the rest still runs
        EXTRAS[f"{name}_error"] = f"{type(e).__name__}: {str(e)[:160]}"
        _log(f"section {name}: FAILED {type(e).__name__}: {e}")
    _write_extras()


# ----------------------------------------------------------------- #
# sections (ordered headline-first; S is the shared cross-section
# namespace: specs, operands, and timings later sections reuse)
# ----------------------------------------------------------------- #

def sec_headline(S):
    """Single-sweep HBM round trip ("smoother sweep bandwidth"): one
    sweep reads u, reads f, writes u = 3 arrays.  Also nu=2 and the
    production nu (per-sweep effective bandwidth counts the nu*3 arrays
    an unfused implementation moves)."""
    ops, psi, f, h, kt = S["ops"], S["psi"], S["f"], S["h"], S["kt"]
    nu, sm, GB = S["nu"], S["sm"], S["GB"]
    t_s1 = kt(lambda u, ff: ops.smooth(u, ff, h, 1, sm, "ghost0"), psi,
              consts=(f,))
    EXTRAS["smoother_roundtrip_gbps"] = round(GB(3) / t_s1, 2)
    EXTRAS["smoother_nu1_time_ms"] = round(t_s1 * 1e3, 4)
    t_s2 = kt(lambda u, ff: ops.smooth(u, ff, h, 2, sm, "ghost0"), psi,
              consts=(f,))
    EXTRAS["smoother_nu2_time_ms"] = round(t_s2 * 1e3, 4)
    EXTRAS["smoother_nu2_phys_gbps"] = round(GB(3) / t_s2, 2)
    t_s = kt(lambda u, ff: ops.smooth(u, ff, h, nu, sm, "ghost0"), psi,
             consts=(f,))
    EXTRAS["smoother_nu_time_ms"] = round(t_s * 1e3, 4)
    EXTRAS["smoother_nu_phys_gbps"] = round(GB(3) / t_s, 2)
    EXTRAS["smoother_nu_effective_gbps"] = round(GB(3 * nu) / t_s, 2)
    S["t_s"] = t_s


def sec_vcycle(S):
    """Full V-cycle + the cycle that also returns sum(r^2); their
    difference prices the residual-stopping metric.  The chained carry
    must depend on BOTH outputs via a runtime zero or XLA
    dead-code-eliminates the norm work."""
    from mgpoisson.cycle.vcycle import v_cycle, v_cycle_rnorm
    psi, f, h, kt, spec = S["psi"], S["f"], S["h"], S["kt"], S["spec"]
    ops, nu, sm = S["ops"], S["nu"], S["sm"]
    z = jnp.zeros((), psi.dtype)

    def _rr_chain(u, ff, zz):
        u2, R = ops.smooth_residual_restrict(u, ff, h, nu, sm, "ghost0")
        return u2.at[0, 0].add(zz * R[0, 0])

    t_rr = kt(_rr_chain, psi, consts=(f, z))
    V = jnp.zeros((spec.size // 2,) * 2, psi.dtype)
    t_pc = kt(lambda u, ff, VV: ops.prolong_correct_smooth(
        u, ff, VV, h, nu, sm, "ghost0", spec.prolong_kind), psi,
        consts=(f, V))
    EXTRAS["rr_fused_time_ms"] = round(t_rr * 1e3, 4)
    EXTRAS["pc_fused_time_ms"] = round(t_pc * 1e3, 4)

    t_vcycle = kt(lambda u, ff: v_cycle(u, ff, h, spec), psi,
                  consts=(f,))
    EXTRAS["vcycle_time_ms"] = round(t_vcycle * 1e3, 4)

    def _rn_chain(u, ff, zz):
        u2, r2 = v_cycle_rnorm(u, ff, h, spec)
        return u2.at[0, 0].add(zz * r2)

    t_vrn = kt(_rn_chain, psi, consts=(f, z))
    EXTRAS["vcycle_rnorm_time_ms"] = round(t_vrn * 1e3, 4)
    EXTRAS["residual_stop_overhead_pct"] = round(
        100.0 * (t_vrn - t_vcycle) / t_vcycle, 2)
    S["t_vcycle"], S["t_vrn"] = t_vcycle, t_vrn


def sec_solve(S):
    """V-cycles and wall time to 1e-10 relative residual (north star
    <10), plus the rbgs scheme's count (the gate with margin)."""
    from mgpoisson import MultigridPoisson, Spec
    mg, f, spec = S["mg"], S["f"], S["spec"]
    res = mg.solve(f)          # compile outside the timed region
    _sync(res.psi)
    t_solve = float("inf")
    for _ in range(2):         # best of 2
        psi0 = mg.init_state(f)
        t0 = time.perf_counter()
        res = mg.solve(f, psi0=psi0)
        _sync(res.psi)
        t_solve = min(t_solve, time.perf_counter() - t0)
    EXTRAS["vcycles_to_1e-10_relres"] = (res.iterations
                                         if res.converged else -1)
    EXTRAS["solve_wall_s"] = round(t_solve, 4)

    spec_rb = Spec(size=spec.size, dtype="float32", scheme="tuned",
                   smoother="rbgs", backend="auto", stop="residual",
                   tol=1e-10)
    res_rb = MultigridPoisson(spec_rb).solve()
    _sync(res_rb.psi)
    EXTRAS["vcycles_to_1e-10_rbgs"] = (res_rb.iterations
                                       if res_rb.converged else -1)


def sec_fast(S):
    """scheme='fast' (rbgs 1+1, the minimum-total-compute scheme from
    tools/tune_scheme.py): cycles to 1e-10 and the compute they cost."""
    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.cycle.vcycle import v_cycle
    psi, f, h, kt, spec = S["psi"], S["f"], S["h"], S["kt"], S["spec"]
    spec_fast = Spec(size=spec.size, dtype="float32", scheme="fast",
                     backend="auto", stop="residual", tol=1e-10)
    mg_fast = MultigridPoisson(spec_fast)
    res_fast = mg_fast.solve(f)
    _sync(res_fast.psi)
    iters = res_fast.iterations if res_fast.converged else -1
    EXTRAS["fast_scheme_cycles_to_1e-10"] = iters
    t_fc = kt(lambda u, ff: v_cycle(u, ff, h, spec_fast), psi,
              consts=(f,))
    EXTRAS["fast_scheme_vcycle_ms"] = round(t_fc * 1e3, 4)
    EXTRAS["fast_scheme_solve_compute_ms"] = round(
        max(iters, 0) * t_fc * 1e3, 3)


def sec_config5(S):
    """Config 5 on one card: 16384^2, tuned and fast."""
    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.cycle.vcycle import v_cycle
    cfg5 = {}
    EXTRAS["config5_16384"] = cfg5
    spec5 = Spec(size=16384, dtype="float32", scheme="tuned",
                 stop="residual", tol=1e-10)
    mg5 = MultigridPoisson(spec5)
    f5 = mg5.rhs()
    psi5 = mg5.init_state(f5)
    t5 = chain_time(lambda u, ff: v_cycle(u, ff, spec5.fine_h, spec5),
                    psi5, k1=8, k2=48, tries=4, consts=(f5,))
    cfg5["vcycle_time_ms"] = round(t5 * 1e3, 4)
    res5 = mg5.solve(f5)
    _sync(res5.psi)
    w5 = float("inf")
    for _ in range(2):
        p5 = mg5.init_state(f5)
        t0 = time.perf_counter()
        res5 = mg5.solve(f5, psi0=p5)
        _sync(res5.psi)
        w5 = min(w5, time.perf_counter() - t0)
    cfg5["cycles"] = res5.iterations if res5.converged else -1
    cfg5["solve_wall_s"] = round(w5, 4)
    # scheme='fast' at config-5 scale
    spec5f = spec5.with_(scheme="fast")
    mg5f = MultigridPoisson(spec5f)
    res5f = mg5f.solve(f5)
    _sync(res5f.psi)
    cfg5["fast_cycles"] = res5f.iterations if res5f.converged else -1
    t5f = chain_time(lambda u, ff: v_cycle(u, ff, spec5f.fine_h,
                                           spec5f), psi5,
                     k1=8, k2=48, tries=4, consts=(f5,))
    cfg5["fast_vcycle_time_ms"] = round(t5f * 1e3, 4)
    cfg5["fast_solve_compute_ms"] = round(
        max(cfg5["fast_cycles"], 0) * t5f * 1e3, 2)
    stats = jax.devices()[0].memory_stats() or {}
    cfg5["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")


def sec_spmd(S):
    """Explicit shard_map partition on a (1,1) mesh against the
    unsharded rnorm V-cycle (the like-for-like comparison: the spmd
    step computes the metric too)."""
    from mgpoisson.shard.mesh import build_mesh
    from mgpoisson.shard.spmd import build_spmd_step
    from mgpoisson import Spec
    psi, f, kt, spec = S["psi"], S["f"], S["kt"], S["spec"]
    spec_s = spec.with_(mesh_shape=(1, 1), partition="spmd")
    mesh1 = build_mesh((1, 1), devices=jax.devices()[:1])
    sstep = jax.jit(build_spmd_step(spec_s, mesh1))
    t_spmd = kt(lambda u, ff: sstep(u, ff)[0], psi, consts=(f,))
    EXTRAS["spmd_1x1_step_ms"] = round(t_spmd * 1e3, 4)
    if "t_vrn" in S:
        EXTRAS["spmd_vs_unsharded_vcycle"] = round(t_spmd / S["t_vrn"],
                                                   4)
    # 3D analog on a (1,1) mesh
    nu = S["nu"]
    spec3s = Spec(size=256, ndim=3, dtype="float32", scheme="tuned",
                  backend="auto", pre_smooth=nu, post_smooth=nu,
                  mesh_shape=(1, 1), partition="spmd", stop="residual")
    sstep3 = jax.jit(build_spmd_step(spec3s, mesh1))
    f3s = jnp.zeros((256,) * 3, jnp.float32).at[(128,) * 3].set(-1e6)
    t_spmd3 = kt(lambda u, ff: sstep3(u, ff)[0], -f3s, consts=(f3s,))
    EXTRAS["spmd3d_1x1_step_ms"] = round(t_spmd3 * 1e3, 4)


def sec_parity(S):
    """The compiled Hopper smoother against `xla.smooth` on the device
    (mgpoisson/bench/parity.py).  Skippable with
    MGPOISSON_BENCH_PARITY=0."""
    if os.environ.get("MGPOISSON_BENCH_PARITY", "1") == "0":
        EXTRAS["kernel_parity_skipped"] = True
        return
    from mgpoisson.bench.parity import run_parity
    pres = run_parity()
    EXTRAS["kernel_parity_max_err"] = pres["max_err_f32"]
    EXTRAS["kernel_parity_worst"] = pres["worst_f32"]
    EXTRAS["kernel_parity_max_err_bf16"] = pres["max_err_bf16"]
    EXTRAS["kernel_parity_n_cases"] = pres["n_cases"]
    if pres["failures"]:
        EXTRAS["kernel_parity_failures"] = pres["failures"]


def sec_fmg(S):
    """FMG-initialized solve: full multigrid reaches discretization
    accuracy in one O(N) pass, then V-cycles polish."""
    from mgpoisson import MultigridPoisson, Spec
    f, spec = S["f"], S["spec"]
    spec_f = Spec(size=spec.size, dtype="float32", scheme="tuned",
                  backend="auto", stop="residual", tol=1e-10,
                  cycle="fmg")
    mg_f = MultigridPoisson(spec_f)
    res_f = mg_f.solve(f)
    _sync(res_f.psi)
    t_fmg = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        res_f = mg_f.solve(f)      # includes the FMG init pass
        _sync(res_f.psi)
        t_fmg = min(t_fmg, time.perf_counter() - t0)
    EXTRAS["fmg_vcycles_to_1e-10"] = (res_f.iterations
                                      if res_f.converged else -1)
    EXTRAS["fmg_solve_wall_s"] = round(t_fmg, 4)


def sec_adaptive(S):
    """stop_check='adaptive': exact ||r|| cycles run only when the
    learned contraction model predicts the residual is near tol;
    n_metric_evals counts them and the chained per-cycle timings
    price the amortized metric cost."""
    from mgpoisson import MultigridPoisson
    f, spec = S["f"], S["spec"]
    mg_a = MultigridPoisson(spec.with_(stop_check="adaptive"))
    res_a = mg_a.solve(f)
    EXTRAS["adaptive_cycles"] = res_a.iterations
    EXTRAS["adaptive_metric_evals"] = res_a.n_metric_evals
    EXTRAS["adaptive_converged"] = bool(res_a.converged)
    if "t_vrn" in S and "t_vcycle" in S:
        EXTRAS["adaptive_stop_overhead_pct"] = round(
            100.0 * res_a.n_metric_evals * (S["t_vrn"] - S["t_vcycle"])
            / (res_a.iterations * S["t_vcycle"]), 2)


def sec_bf16(S):
    """bf16: half the HBM bytes per cell -> the sweep should run ~2x
    faster than f32 at the same GB/s (bandwidth-bound check).  Plus
    the end-to-end story: (a) pure-bf16 solve floor — bf16 residuals
    stall below ~3 decimal digits, which is WHY refinement exists;
    (b) mixed refinement (Spec.sweep_dtype='bfloat16'): bf16 V-cycles
    on the error equation inside an f32 outer loop."""
    from mgpoisson import MultigridPoisson
    from mgpoisson.kernels import xla as xla_ops
    ops, psi, f, h, kt = S["ops"], S["psi"], S["f"], S["h"], S["kt"]
    spec, sm = S["spec"], S["sm"]
    n_cells = spec.size * spec.size
    psi_bf = psi.astype(jnp.bfloat16)
    f_bf = f.astype(jnp.bfloat16)
    t_s1_bf = kt(lambda u, ff: ops.smooth(u, ff, h, 1, sm, "ghost0"),
                 psi_bf, consts=(f_bf,))
    EXTRAS["bf16_smoother_nu1_time_ms"] = round(t_s1_bf * 1e3, 4)
    EXTRAS["bf16_smoother_phys_gbps"] = round(
        (3 * n_cells * 2) / 1e9 / t_s1_bf, 2)
    if EXTRAS.get("smoother_nu1_time_ms"):
        EXTRAS["bf16_speedup_vs_f32"] = round(
            EXTRAS["smoother_nu1_time_ms"] / (t_s1_bf * 1e3), 3)
    try:
        spec_bf = spec.with_(dtype="bfloat16", tol=1e-30, maxiter=12)
        mg_bf = MultigridPoisson(spec_bf)
        f_bf16 = mg_bf.rhs()
        res_bf = mg_bf.solve(f_bf16)
        _sync(res_bf.psi)
        p32 = res_bf.psi.astype(jnp.float32)
        f32r = f_bf16.astype(jnp.float32)
        rr32 = ops.residual(p32, f32r, h, "ghost0")
        rel_bf = float(jnp.linalg.norm(rr32.astype(jnp.float32))
                       / jnp.linalg.norm(f32r))
        EXTRAS["bf16_solve_floor_relres"] = float(f"{rel_bf:.3e}")
        EXTRAS["bf16_solve_cycles"] = res_bf.iterations
    except Exception as e:  # pragma: no cover
        EXTRAS["bf16_floor_error"] = f"{type(e).__name__}: {str(e)[:120]}"
    try:
        spec_mx = spec.with_(sweep_dtype="bfloat16")
        mg_mx = MultigridPoisson(spec_mx)
        res_mx = mg_mx.solve(f)
        _sync(res_mx.psi)
        rel_mx = float(xla_ops.residual_norm(res_mx.psi, f, h)
                       / xla_ops.residual_norm(mg_mx.init_state(f), f,
                                               h))
        t_mx = kt(lambda u, ff: mg_mx._step_fn(
            u, ff, jnp.asarray(1.0, jnp.float32))[0], psi, consts=(f,))
        EXTRAS["mixed_bf16_cycles_to_tol"] = res_mx.iterations
        EXTRAS["mixed_bf16_converged"] = bool(res_mx.converged)
        EXTRAS["mixed_bf16_final_relres"] = float(f"{rel_mx:.3e}")
        EXTRAS["mixed_bf16_step_time_ms"] = round(t_mx * 1e3, 4)
    except Exception as e:  # pragma: no cover
        EXTRAS["mixed_bf16_error"] = f"{type(e).__name__}: {str(e)[:120]}"


def sec_3d(S):
    """3D (BASELINE config 4): 256^3 V-cycle (7-point Laplacian), a
    512^3 scaling point, and the batched-serving loop (4 RHS per
    program at 1024^2)."""
    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.cycle.vcycle import v_cycle
    from mgpoisson.kernels import get_ops
    on_gpu, nu = S["on_gpu"], S["nu"]
    size3 = int(os.environ.get("MGPOISSON_BENCH_SIZE3",
                               256 if on_gpu else 64))
    spec3 = Spec(size=size3, ndim=3, dtype="float32", scheme="tuned",
                 pre_smooth=nu, post_smooth=nu)
    f3 = jnp.zeros((size3,) * 3, jnp.float32).at[
        (size3 // 2,) * 3].set(-1e6)
    t_vcycle3 = chain_time(
        lambda u, ff: v_cycle(u, ff, spec3.fine_h, spec3), -f3,
        consts=(f3,))
    EXTRAS["vcycle3d_time_ms"] = round(t_vcycle3 * 1e3, 4)
    EXTRAS["size3d"] = size3
    EXTRAS["backend_3d"] = get_ops(spec3, size3).__name__.split(".")[-1]
    if not on_gpu:
        return
    try:
        spec3b = spec3.with_(size=512)
        f3b = jnp.zeros((512,) * 3, jnp.float32).at[
            (256,) * 3].set(-1e6)
        t3b = chain_time(
            lambda u, ff: v_cycle(u, ff, spec3b.fine_h, spec3b),
            -f3b, consts=(f3b,))
        EXTRAS["vcycle3d_512_time_ms"] = round(t3b * 1e3, 4)
    except Exception as e:  # pragma: no cover
        EXTRAS["vcycle3d_512_error"] = (
            f"{type(e).__name__}: {str(e)[:120]}")
    try:
        specb = Spec(size=1024, dtype="float32", scheme="tuned",
                     backend="auto", stop="residual", tol=1e-10,
                     pre_smooth=nu, post_smooth=nu)
        mgb = MultigridPoisson(specb)
        fsb = jnp.zeros((4, 1024, 1024), jnp.float32).at[
            :, 512, 512].set(-1e6)
        psb, esb = mgb.solve_batched(fsb)
        EXTRAS["batched4_1024_max_metric"] = float(jnp.max(esb))
        loop1 = mgb._batched_loop(1)
        r0sb = jnp.ones((4,), jnp.float32)
        t_b = chain_time(lambda ps, ff: loop1(ps, ff, r0sb)[0], -fsb,
                         consts=(fsb,))
        EXTRAS["batched4_1024_cycle_ms"] = round(t_b * 1e3, 4)
    except Exception as e:  # pragma: no cover
        EXTRAS["batched_error"] = f"{type(e).__name__}: {str(e)[:120]}"


def main():
    platform = jax.devices()[0].platform
    on_gpu = platform == "gpu"
    rehearsal = os.environ.get("JAX_PLATFORMS", "").strip() == "cpu"
    if not on_gpu and not rehearsal:
        sys.exit(f"bench.py measures a GPU; JAX found {platform!r} "
                 "(set JAX_PLATFORMS=cpu for a CPU rehearsal)")
    cache = compile_cache.enable()
    kind = jax.devices()[0].device_kind
    _log(f"{platform} {kind}; deadline {_DEADLINE:.0f}s; extras -> "
         f"{EXTRAS_PATH}; compile cache {cache}")

    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.kernels import get_ops

    size = int(os.environ.get("MGPOISSON_BENCH_SIZE",
                              4096 if on_gpu else 512))
    # long chains for sub-ms kernels on the GPU; short on the CPU
    kt = functools.partial(chain_time, k1=20, k2=220, tries=5) \
        if on_gpu else chain_time

    spec = Spec(size=size, dtype="float32", scheme="tuned",
                backend="auto", stop="residual", tol=1e-10)
    mg = MultigridPoisson(spec)
    f = mg.rhs()
    bytes_per = jnp.dtype(spec.dtype).itemsize
    n_cells = size * size
    S = {
        "spec": spec, "mg": mg, "f": f, "psi": mg.init_state(f),
        "h": spec.fine_h, "ops": get_ops(spec, size), "kt": kt,
        "nu": spec.nu_pre, "sm": spec.smoother_resolved,
        "on_gpu": on_gpu,
        "GB": lambda arrays: arrays * n_cells * bytes_per / 1e9,
    }
    EXTRAS.update({
        "platform": platform, "device_kind": kind,
        "device_count": len(jax.devices()), "size": size,
        "smoother": S["sm"], "nu": S["nu"],
        "backend_fine_level": S["ops"].__name__.split(".")[-1],
        "hbm_peak_gbps": hbm_peak_gbps(kind) if on_gpu else None,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    })

    # (name, min-budget-seconds before starting, fn); parity runs last
    sections = [
        ("headline", 90, sec_headline),
        ("vcycle", 90, sec_vcycle),
        ("solve", 80, sec_solve),
        ("fast", 60, sec_fast),
        ("config5", 200, sec_config5),
        ("spmd", 110, sec_spmd),
        ("fmg", 60, sec_fmg),
        ("adaptive", 60, sec_adaptive),
        ("bf16", 110, sec_bf16),
        ("3d", 140, sec_3d),
        ("parity", 150, sec_parity),
    ]
    if not on_gpu:
        # the CPU rehearsal runs the core sections at toy sizes
        keep = {"headline", "vcycle", "solve", "fmg", "adaptive", "3d"}
        sections = [s for s in sections if s[0] in keep]
    for name, budget, fn in sections:
        _section(name, budget, fn, S)
    _emit_final()


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        EXTRAS["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        _log(f"FATAL: {type(e).__name__}: {e}")
        _emit_final(note=f"fatal: {type(e).__name__}")
        sys.exit(1)
