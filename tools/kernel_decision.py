#!/usr/bin/env python
"""Measure whether the Hopper smoother kernel earns its place.

Usage (on a machine with one NVIDIA GPU):

    python tools/kernel_decision.py [--quick] [--out bench_out/kernel_decision.jsonl]

Steps, each printed as one JSON line and appended to --out:
  1. the fusions XLA makes of one `xla.smooth` call at 4096^2
     (wjacobi nu=3 and rbgs nu=1), read from the optimized HLO;
  2. kernel vs `xla.smooth` time on every fine level 1024^2..16384^2,
     wjacobi nu=3, rbgs nu=1 and jacobi nu=7, f32 and bf16, with the
     normalized max difference between the two;
  3. the tuned and fast 4096^2 and 16384^2 solves to 1e-10 end to end,
     backend='xla' and backend='auto' in turns (xla, auto, auto, xla).
Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

OUT = None


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        with open(OUT, "a") as fh:
            fh.write(line + "\n")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def fusions(fn, *args) -> list:
    """Names of the kernels (fusions and custom calls) in the ENTRY
    computation of the optimized HLO."""
    text = jax.jit(fn).lower(*args).compile().as_text()
    entry = text[text.index("ENTRY"):]
    entry = entry[:entry.index("\n}")]
    return re.findall(r"= \S+ (fusion|custom-call)\(", entry)


def norm_diff(a, b) -> float:
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return float(jnp.max(jnp.abs(a - b)) / jnp.maximum(jnp.max(jnp.abs(b)),
                                                        1e-30))


def data(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.normal(size=(n, n)), dtype),
            jnp.asarray(rng.normal(size=(n, n)), dtype))


def main(argv=None):
    global OUT
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="bench_out/kernel_decision.jsonl")
    p.add_argument("--quick", action="store_true",
                   help="steps 1-2 at 4096^2 only, no solves")
    args = p.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {jax.devices()[0].platform}")
    from mgpoisson.utils import compile_cache
    cache = compile_cache.enable()
    OUT = args.out
    os.makedirs(os.path.dirname(OUT) or ".", exist_ok=True)

    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.bench.timing import chain_time, sync
    from mgpoisson.kernels import hopper, xla

    emit({"card": card(), "jax": jax.__version__,
          "device_kind": jax.devices()[0].device_kind,
          "xla_flags": os.environ.get("XLA_FLAGS", ""), "cache": cache})

    # 1. what XLA makes of the nu-sweep smoother
    u, f = data(4096, jnp.float32)
    for sm, nu in (("wjacobi", 3), ("rbgs", 1)):
        ks = fusions(lambda a, b: xla.smooth(a, b, 1 / 4096, nu, sm,
                                             "ghost0"), u, f)
        emit({"step": "hlo", "n": 4096, "smoother": sm, "nu": nu,
              "kernels": len(ks), "kinds": ks})

    kt = lambda fn, x, c: chain_time(fn, x, k1=5, k2=25, tries=5,
                                     consts=c)

    # 2. every fine level
    sizes = (4096,) if args.quick else (1024, 2048, 4096, 8192, 16384)
    for n in sizes:
        for dtype in (jnp.float32, jnp.bfloat16):
            u, f = data(n, dtype)
            for sm, nu in (("wjacobi", 3), ("rbgs", 1), ("jacobi", 7)):
                h = 1.0 / n
                fk = lambda a, b: hopper.smooth_pallas(a, b, h, nu, sm,
                                                       "ghost0")
                fx = lambda a, b: xla.smooth(a, b, h, nu, sm, "ghost0")
                rec = {"step": "level", "n": n,
                       "dtype": jnp.dtype(dtype).name, "smoother": sm,
                       "nu": nu, "block": hopper.BLOCK,
                       "preferred": hopper.preferred(dtype, sm, nu)}
                try:
                    rec["err"] = norm_diff(jax.jit(fk)(u, f),
                                           jax.jit(fx)(u, f))
                    rec["xla_ms"] = kt(fx, u, (f,)) * 1e3
                    rec["kernel_ms"] = kt(fk, u, (f,)) * 1e3
                    rec["speedup"] = rec["xla_ms"] / rec["kernel_ms"]
                except Exception as e:  # noqa: BLE001
                    rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
                emit(rec)
            del u, f
    if args.quick:
        return

    # 3. end-to-end solves, the two backends in turns
    for n in (4096, 16384):
        for scheme in ("tuned", "fast"):
            for backend in ("xla", "auto", "auto", "xla"):
                spec = Spec(size=n, scheme=scheme, stop="residual",
                            tol=1e-10, backend=backend)
                rec = {"step": "solve", "n": n, "scheme": scheme,
                       "backend": backend}
                try:
                    mg = MultigridPoisson(spec)
                    fr = mg.rhs()
                    res = mg.solve(fr)
                    sync(res.psi)
                    walls = []
                    for _ in range(5):
                        p0 = mg.init_state(fr)
                        sync(p0)
                        t0 = time.perf_counter()
                        res = mg.solve(fr, psi0=p0)
                        sync(res.psi)
                        walls.append(time.perf_counter() - t0)
                    rec.update(cycles=res.iterations,
                               converged=bool(res.converged),
                               final=res.final_err,
                               wall_ms=[w * 1e3 for w in walls],
                               best_ms=min(walls) * 1e3)
                    del mg, res, fr
                except Exception as e:  # noqa: BLE001
                    rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
                emit(rec)
    emit({"card_after": card()})


if __name__ == "__main__":
    main()
