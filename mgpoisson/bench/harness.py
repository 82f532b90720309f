"""Wall-time benchmark harness — the rebuild of `test/test.lua`.

The reference times `run()` per variant per size with best-of-`tries`
os.clock() and writes a TSV + gnuplot PNG (`test/test.lua:44-76`).  Its
variant ladder (cpu.lua -> cpu-raw.lua -> gpu.lua -> cpu-gpu.lua) maps
here to:

  oracle  — pure-NumPy float64 (cpu.lua, the readable reference)
  native  — C++ solver via ctypes (cpu-raw.lua, the raw-pointer CPU path)
  xla     — jnp ops on the default JAX backend (gpu.lua's role)
  pallas  — the Hopper smoother kernel where it applies (GPU only)
  auto    — kernel fine levels + xla coarse levels (cpu-gpu.lua's
            heterogeneous split, reborn as a level-size threshold)

Usage: python -m mgpoisson.bench.harness [--sizes 64,256,1024] \
          [--variants xla,auto] [--tries 3] [--cycles 4] [--out bench_out]

Writes <out>/times.tsv (size, variant, best seconds per V-cycle) and,
when matplotlib is importable, <out>/times.png.

Fixes the committed harness's bitrot: the reference passes a bare
number where MultigridCPU:init expects a table and references an
undefined gnuplot data var (`test/test.lua:54,69` — SURVEY.md 4.4).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List


def _time_variant(variant: str, size: int, cycles: int, tries: int) -> float:
    """Best-of-`tries` seconds for `cycles` V-cycles (tuned scheme)."""
    if variant == "oracle":
        import numpy as np
        from mgpoisson import oracle
        f = oracle.point_charge_rhs(size)
        h = 1.0 / size
        best = float("inf")
        for _ in range(tries):
            psi = -f
            t0 = time.perf_counter()
            for _ in range(cycles):
                psi = oracle.v_cycle(psi, f, h, pre_smooth=2, post_smooth=2,
                                     smoother="rbgs", scheme="tuned")
            best = min(best, time.perf_counter() - t0)
        return best / cycles

    if variant == "native":
        from mgpoisson.native import MultigridNative
        mg = MultigridNative(size, pre_smooth=2, post_smooth=2,
                             smoother="rbgs", scheme="tuned")
        f = mg.point_charge_rhs()
        best = float("inf")
        for _ in range(tries):
            psi = -f
            t0 = time.perf_counter()
            for _ in range(cycles):
                psi = mg.v_cycle(psi, f)
            best = min(best, time.perf_counter() - t0)
        return best / cycles

    import jax
    import jax.numpy as jnp
    from mgpoisson import Spec
    from mgpoisson.cycle.vcycle import v_cycle

    backend = {"xla": "xla", "pallas": "pallas", "auto": "auto"}[variant]
    spec = Spec(size=size, dtype="float32", scheme="tuned", backend=backend)
    f = jnp.zeros((size, size), jnp.float32).at[size // 2, size // 2].set(-1e6)
    h = 1.0 / size

    from mgpoisson.bench.timing import chain_time

    # the chain-length difference scales inversely with grid area so the
    # measured work (~100-300 ms) dominates sync jitter at every size
    delta = max(40, min(4000, (4096 // size) ** 2 * 40))
    best = float("inf")
    for _ in range(tries):
        t = chain_time(lambda c, ff: v_cycle(c, ff, h, spec), -f,
                       k1=10, k2=10 + delta, tries=1, consts=(f,))
        best = min(best, t)
    return best


def run_harness(sizes: List[int], variants: List[str], tries: int,
                cycles: int, out_dir: str) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for size in sizes:
        for variant in variants:
            try:
                t = _time_variant(variant, size, cycles, tries)
            except Exception as e:  # variant unavailable on this host
                print(f"size={size} variant={variant}: skipped ({e})")
                continue
            rows.append((size, variant, t))
            print(f"size={size:6d} variant={variant:7s} "
                  f"{t * 1e3:9.3f} ms/V-cycle")

    tsv = os.path.join(out_dir, "times.tsv")
    with open(tsv, "w") as fh:
        fh.write("size\tvariant\tseconds_per_vcycle\n")
        for size, variant, t in rows:
            fh.write(f"{size}\t{variant}\t{t:.6e}\n")
    print(f"wrote {tsv}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for variant in variants:
            pts = [(s, t) for s, v, t in rows if v == variant]
            if pts:
                ax.plot([p[0] for p in pts], [p[1] for p in pts],
                        marker="o", label=variant)
        ax.set_xscale("log", base=2)
        ax.set_yscale("log")
        ax.set_xlabel("grid side")
        ax.set_ylabel("seconds per V-cycle")
        ax.legend()
        ax.set_title("mgpoisson V-cycle wall time")
        png = os.path.join(out_dir, "times.png")
        fig.savefig(png, dpi=120)
        print(f"wrote {png}")
    except Exception as e:
        print(f"plot skipped ({e})")
    return {"rows": rows}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", default="64,256,1024")
    p.add_argument("--variants", default="xla,auto")
    p.add_argument("--tries", type=int, default=3)
    p.add_argument("--cycles", type=int, default=4)
    p.add_argument("--out", default="bench_out")
    args = p.parse_args(argv)
    run_harness([int(s) for s in args.sizes.split(",")],
                args.variants.split(","), args.tries, args.cycles, args.out)


if __name__ == "__main__":
    main()
