#!/usr/bin/env python
"""Compare smoother schemes on solve wall time at one size.

Usage: python tools/tune_scheme.py [size]

For each (smoother, nu) candidate: times one V-cycle (chained-scan,
overhead-cancelled), runs the full solve to 1e-10 relative residual,
and reports cycles + amortized cycle cost.  The reference tunes its
smoother count by hand (`cpu.lua:20` uses 7+7); this sweep picks the
scheme whose cycles x cycle-time is smallest, not the one with the
fewest sweeps.
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgpoisson.utils import compile_cache

compile_cache.enable()


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.bench.timing import chain_time, sync
    from mgpoisson.cycle.vcycle import v_cycle

    kt = functools.partial(chain_time, k1=20, k2=220, tries=5)

    candidates = [
        ("wjacobi", 3, 3),   # current tuned default
        ("wjacobi", 2, 2),
        ("rbgs", 2, 2),
        ("rbgs", 1, 1),
    ]
    rows = []
    for sm, pre, post in candidates:
        spec = Spec(size=size, dtype="float32", scheme="tuned",
                    smoother=sm, pre_smooth=pre, post_smooth=post,
                    backend="auto", stop="residual", tol=1e-10)
        row = {"smoother": sm, "nu": f"{pre}+{post}"}
        try:
            mg = MultigridPoisson(spec)
            f = mg.rhs()
            psi = mg.init_state(f)
            row["vcycle_ms"] = round(kt(
                lambda u, ff, spec=spec: v_cycle(u, ff, spec.fine_h,
                                                 spec),
                psi, consts=(f,)) * 1e3, 4)
            res = mg.solve(f)              # compile + converge check
            sync(res.psi)
            row["cycles"] = res.iterations if res.converged else -1
            w = float("inf")
            for _ in range(2):
                p0 = mg.init_state(f)
                t0 = time.perf_counter()
                res = mg.solve(f, psi0=p0)
                sync(res.psi)
                w = min(w, time.perf_counter() - t0)
            row["solve_wall_s"] = round(w, 4)
            row["cycles_x_vcycle_ms"] = round(
                row["cycles"] * row["vcycle_ms"], 3)
        except Exception as e:
            row["error"] = f"{type(e).__name__}: {str(e)[:160]}"
        rows.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
