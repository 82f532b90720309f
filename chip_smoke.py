#!/usr/bin/env python
"""Smoke test of the solver on one NVIDIA GPU.

Usage, from the root of a checkout:

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --four     # four cards: the sharded step only

Phases (each one failing the script with a non-zero exit):
  1. device - JAX must see a GPU; there is no fallback.
  2. vcycle - one tuned V-cycle at 1024^2 f32 against the float64
     oracle (mgpoisson/oracle.py), normalized max difference <= 1e-5.
  3. solves - through `MultigridPoisson.solve()`: 4096^2 tuned and fast
     to 1e-10 relative residual (cycle counts within +-1 of the CPU's),
     16384^2 tuned with its memory figures, a 3D 256^3 solve and one
     512^3 V-cycle, the mixed bf16/f32 solve at 4096^2 and
     `solve_batched` on 4 x 1024^2.
  4. kernel - the Hopper smoother (mgpoisson/kernels/hopper.py)
     compiled at 4096^2, 8192^2 and 16384^2 for every smoother it
     serves, against `xla.smooth`: f32 <= 1e-6, bf16 <= 3e-2.
  --four: partition='spmd' and 'gspmd' on a (2, 2) mesh, a 16384^2 2D
     step and a 256^3 3D step, each <= 1e-5 from the single-card step.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Cycle counts to 1e-10 relative residual of the point-charge problem at
# 4096^2 f32, as the CPU backend runs the same Spec (phase 3 checks the
# card against them, +-1).
CPU_CYCLES_4096 = {"tuned": 9, "fast": 2}

F32_TOL = 1e-6          # kernel vs xla.smooth, same precision
BF16_TOL = 3e-2         # bf16 nu-sweep rounding-order noise
STEP_TOL = 1e-5         # f32 roundoff of one V-cycle


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    """The card's name and power limit, read without touching JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def norm_diff(a, b) -> float:
    a = np.asarray(jnp.asarray(a, jnp.float32), np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def sync(x):
    return jax.block_until_ready(x)


def timed_solve(mg, f, reps: int = 2):
    """Compile and run once, then the best warm wall time of `reps`."""
    res = mg.solve(f)
    sync(res.psi)
    best = float("inf")
    for _ in range(reps):
        p0 = sync(mg.init_state(f))
        t0 = time.perf_counter()
        res = mg.solve(f, psi0=p0)
        sync(res.psi)
        best = min(best, time.perf_counter() - t0)
    return res, best


# ------------------------------------------------------------------ phases

def phase_device():
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"phase device: JAX found {dev.platform!r}, not a GPU")
    return dev


def phase_vcycle(n: int = 1024, tol: float = STEP_TOL):
    """One tuned V-cycle on the device against the float64 oracle."""
    from mgpoisson import Spec, oracle
    from mgpoisson.cycle.vcycle import v_cycle

    spec = Spec(size=n, scheme="tuned")
    f = oracle.point_charge_rhs(n)
    with jax.default_matmul_precision("highest"):
        got = jax.jit(lambda u, ff: v_cycle(u, ff, spec.fine_h, spec))(
            jnp.asarray(-f, jnp.float32), jnp.asarray(f, jnp.float32))
        got = sync(got)
    want = oracle.v_cycle(-f, f, spec.fine_h, pre_smooth=spec.nu_pre,
                          post_smooth=spec.nu_post,
                          smoother=spec.smoother_resolved, scheme="tuned")
    d = norm_diff(got, want)
    log(f"phase vcycle: {n}^2 tuned f32 vs float64 oracle: "
        f"normalized max diff {d:.3e} (limit {tol:g})")
    check(d <= tol, f"phase vcycle: {d:.3e} > {tol:g}")
    return d


def phase_solves(card: str, n2: int = 4096, n_big: int = 16384,
                 n3: int = 256, n3_cycle: int = 512, n_batch: int = 1024,
                 cpu_cycles=CPU_CYCLES_4096):
    """The user-facing solves; returns {name: (cycles, metric, seconds)}."""
    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.cycle.vcycle import v_cycle

    out = {}

    def report(name, res, wall):
        log(f"phase solves: {name}: {res.iterations} cycles, final "
            f"{res.final_err:.3e}, converged {res.converged}, warm wall "
            f"{wall * 1e3:.3f} ms on {card}")
        out[name] = (res.iterations, res.final_err, wall)

    for scheme in ("tuned", "fast"):
        mg = MultigridPoisson(Spec(size=n2, scheme=scheme, stop="residual",
                                   tol=1e-10))
        res, wall = timed_solve(mg, mg.rhs())
        report(f"{n2}^2 {scheme}", res, wall)
        check(res.converged, f"{scheme} {n2}^2 did not converge")
        if scheme == "tuned":
            check(res.iterations < 10,
                  f"tuned {n2}^2 took {res.iterations} >= 10 cycles")
        if cpu_cycles:
            want = cpu_cycles[scheme]
            check(abs(res.iterations - want) <= 1,
                  f"{scheme} {n2}^2: {res.iterations} cycles, CPU {want}")

    spec = Spec(size=n_big, scheme="tuned", stop="residual", tol=1e-10)
    mg = MultigridPoisson(spec)
    f = mg.rhs()
    res, wall = timed_solve(mg, f)
    report(f"{n_big}^2 tuned", res, wall)
    check(res.converged, f"tuned {n_big}^2 did not converge")
    r0 = mg._r0(mg.init_state(f), f)
    mem = mg._solve_loop.lower(mg.init_state(f), f, r0).compile() \
        .memory_analysis()
    log(f"phase solves: {n_big}^2 memory_analysis: {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"phase solves: {n_big}^2 peak_bytes_in_use: "
        f"{stats.get('peak_bytes_in_use')}")
    del mg, f, res

    mg3 = MultigridPoisson(Spec(size=n3, ndim=3, scheme="tuned",
                                stop="residual", tol=1e-10))
    res, wall = timed_solve(mg3, mg3.rhs())
    report(f"{n3}^3 tuned", res, wall)
    check(res.converged, f"3D {n3}^3 did not converge")
    del mg3, res

    spec3 = Spec(size=n3_cycle, ndim=3, scheme="tuned")
    f3 = jnp.zeros((n3_cycle,) * 3, jnp.float32).at[
        (n3_cycle // 2,) * 3].set(-1e6)
    cyc = jax.jit(lambda u, ff: v_cycle(u, ff, spec3.fine_h, spec3))
    u3 = sync(cyc(-f3, f3))
    t0 = time.perf_counter()
    u3 = sync(cyc(-f3, f3))
    wall = time.perf_counter() - t0
    check(bool(jnp.all(jnp.isfinite(u3))), "512^3 V-cycle not finite")
    log(f"phase solves: one {n3_cycle}^3 V-cycle: finite, warm wall "
        f"{wall * 1e3:.3f} ms on {card}")
    out[f"{n3_cycle}^3 vcycle"] = (1, None, wall)
    del f3, u3

    mg = MultigridPoisson(Spec(size=n2, scheme="tuned", stop="residual",
                               tol=1e-10, sweep_dtype="bfloat16"))
    res, wall = timed_solve(mg, mg.rhs())
    report(f"{n2}^2 mixed bf16/f32", res, wall)
    check(res.converged, "mixed bf16/f32 did not converge")

    mg = MultigridPoisson(Spec(size=n_batch, scheme="tuned",
                               stop="residual", tol=1e-10))
    fs = jnp.stack([mg.rhs() * s for s in (1.0, 0.5, 2.0, -1.0)])
    psis, errs = sync(mg.solve_batched(fs))
    t0 = time.perf_counter()
    psis, errs = sync(mg.solve_batched(fs))
    wall = time.perf_counter() - t0
    worst = float(jnp.max(errs))
    log(f"phase solves: solve_batched 4 x {n_batch}^2: worst metric "
        f"{worst:.3e}, warm wall {wall * 1e3:.3f} ms on {card}")
    check(psis.shape == fs.shape and worst < 1e-10,
          f"solve_batched: worst metric {worst:.3e}")
    out[f"batched 4x{n_batch}^2"] = (None, worst, wall)
    return out


def phase_kernel(card: str, sizes=(4096, 8192, 16384), interpret=False,
                 block=None):
    """The Hopper smoother against xla.smooth at real widths."""
    from mgpoisson.bench.timing import chain_time
    from mgpoisson.core.spec import SCHEMES
    from mgpoisson.kernels import hopper, xla

    kw = {"interpret": interpret}
    if block is not None:
        kw["block"] = block
    nus = {"jacobi": SCHEMES["reference"][3], "wjacobi": SCHEMES["tuned"][3],
           "rbgs": SCHEMES["fast"][3]}
    worst = {}
    for n in sizes:
        rng = np.random.default_rng(n)
        for dtype, tol in ((jnp.float32, F32_TOL), (jnp.bfloat16, BF16_TOL)):
            u = jnp.asarray(rng.normal(size=(n, n)), dtype)
            f = jnp.asarray(rng.normal(size=(n, n)), dtype)
            for sm in hopper.RADIUS:
                nu = nus[sm]
                fk = lambda a, b: hopper.smooth_pallas(a, b, 1.0 / n, nu, sm,
                                                       "ghost0", **kw)
                fx = lambda a, b: xla.smooth(a, b, 1.0 / n, nu, sm, "ghost0")
                d = norm_diff(jax.jit(fk)(u, f),
                              np.asarray(jax.jit(fx)(u, f), np.float64))
                name = f"{n}^2 {jnp.dtype(dtype).name} {sm} nu={nu}"
                times = ""
                if not interpret:
                    tk = chain_time(fk, u, k1=3, k2=13, tries=3, consts=(f,))
                    tx = chain_time(fx, u, k1=3, k2=13, tries=3, consts=(f,))
                    times = (f", kernel {tk * 1e3:.4f} ms, xla.smooth "
                             f"{tx * 1e3:.4f} ms on {card}")
                log(f"phase kernel: {name}: diff {d:.3e} (limit {tol:g})"
                    + times)
                check(d <= tol, f"kernel {name}: {d:.3e} > {tol:g}")
                worst[name] = d
    return worst


def phase_four(n2: int = 16384, n3: int = 256, mesh_shape=(2, 2)):
    """spmd and gspmd on a mesh against the single-card step."""
    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.shard.mesh import build_mesh

    ndev = mesh_shape[0] * mesh_shape[1]
    check(len(jax.devices()) >= ndev,
          f"phase four: {len(jax.devices())} devices, need {ndev}")
    mesh = build_mesh(mesh_shape, devices=jax.devices()[:ndev])
    diffs = {}
    for ndim, n in ((2, n2), (3, n3)):
        spec = Spec(size=n, ndim=ndim, scheme="tuned", stop="residual",
                    maxiter=1)
        ref = MultigridPoisson(spec)
        f = ref.rhs()
        psi = ref.init_state(f)
        want, _ = ref.step(psi, f)
        want = np.asarray(sync(want), np.float64)
        for part in ("spmd", "gspmd"):
            mg = MultigridPoisson(spec.with_(mesh_shape=mesh_shape,
                                             partition=part), mesh=mesh)
            got, err = mg.step(psi, f)
            got = sync(got)
            shards = len({s.device for s in got.addressable_shards})
            d = norm_diff(got, want)
            name = f"{part} {n}^{ndim} on {mesh_shape}"
            log(f"phase four: {name}: {shards} shards, normalized max "
                f"diff vs one card {d:.3e} (limit {STEP_TOL:g})")
            check(np.isfinite(float(err)), f"{name}: non-finite metric")
            check(shards == ndev, f"{name}: {shards} shards, not {ndev}")
            check(d <= STEP_TOL, f"{name}: {d:.3e} > {STEP_TOL:g}")
            diffs[name] = d
        del ref, f, psi, want
    return diffs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--four", action="store_true",
                   help="run only the sharded step on a (2, 2) mesh")
    args = p.parse_args(argv)

    card = card_line()
    log(f"card: {card}")
    log(f"jax {jax.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}")
    dev = phase_device()
    log(f"device_kind: {dev.device_kind}, count {len(jax.devices())}")
    from mgpoisson.utils import compile_cache
    log(f"compile cache: {compile_cache.enable()}")

    if args.four:
        phase_four()
    else:
        phase_vcycle()
        phase_solves(card)
        phase_kernel(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
