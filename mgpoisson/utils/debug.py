"""Debug / validation subsystem — the reference's `show`/`showAndCheck`
machinery (SURVEY.md section 2.2 component #5).

The reference's debug mode dumps every V-cycle stage (f, u, r, R, V, v
per level) in a common format so CPU and GPU traces can be diffed
(`cpu-raw.lua:126-140`, `gpu.lua:269-284`), and hard-errors on any
non-finite value ("found a nan", `cpu-raw.lua:135-139`).  Here:

- `validate_cycle` runs one traced V-cycle, checks every stage finite
  (raising NonFiniteError naming the stage and level), and returns the
  trace.
- `compare_traces` diffs two stage traces (e.g. XLA vs oracle vs
  native) and reports the worst deviation per stage — the
  cross-implementation differential mechanism as a library function.
- `dump_trace` prints stages in a reference-style format.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class NonFiniteError(RuntimeError):
    """Raised when a stage contains NaN/Inf ("found a nan",
    `cpu-raw.lua:137`)."""


def check_finite(name: str, arr, level_size: int = None) -> None:
    a = np.asarray(arr)
    if not np.isfinite(a).all():
        n_bad = int((~np.isfinite(a)).sum())
        where = f" at level size {level_size}" if level_size else ""
        raise NonFiniteError(
            f"found a nan: stage {name!r}{where} has {n_bad} non-finite "
            f"value(s)")


def validate_cycle(spec, u, f):
    """Run one V-cycle with stage tracing and finite-checking.

    Returns (u_new, trace) where trace is [(stage, level_size, array)].
    The JAX form of running the reference with debug=true
    (`cpu.lua:177`).
    """
    from mgpoisson.cycle.vcycle import v_cycle
    trace = []
    u_new = v_cycle(u, f, spec.fine_h, spec, trace=trace)
    for name, lsize, arr in trace:
        check_finite(name, arr, lsize)
    check_finite("u_out", u_new)
    return u_new, trace


def compare_traces(ta: Sequence[Tuple], tb: Sequence[Tuple],
                   rtol: float = 1e-6, atol: float = 1e-8) -> List[dict]:
    """Stage-by-stage diff of two cycle traces.

    Returns a report: one dict per stage with the max abs/rel deviation
    and an `ok` flag.  Raises ValueError if the stage structures differ
    (different algorithm paths).
    """
    sa = [(n, s) for n, s, _ in ta]
    sb = [(n, s) for n, s, _ in tb]
    if sa != sb:
        raise ValueError(f"trace structures differ: {sa} vs {sb}")
    report = []
    for (name, lsize, a), (_, _, b) in zip(ta, tb):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        adiff = np.abs(a - b).max() if a.size else 0.0
        scale = max(np.abs(b).max(), 1e-300)
        report.append({
            "stage": name,
            "level_size": lsize,
            "max_abs_diff": float(adiff),
            "max_rel_diff": float(adiff / scale),
            "ok": bool(adiff <= atol + rtol * scale),
        })
    return report


def dump_trace(trace, file=None) -> None:
    """Print a trace in the reference's dump style (`cpu-raw.lua:126-134`:
    stage name, then the grid row by row)."""
    import sys
    out = file or sys.stdout
    for name, lsize, arr in trace:
        print(f"L {lsize}", file=out)
        print(name, file=out)
        a = np.asarray(arr)
        if a.ndim == 2 and lsize <= 16:
            for row in a:
                print(" " + " ".join(f"{v:.17g}" for v in row), file=out)
        else:
            print(f"  shape={a.shape} min={a.min():.6e} max={a.max():.6e} "
                  f"norm={np.sqrt((a * a).sum()):.6e}", file=out)
