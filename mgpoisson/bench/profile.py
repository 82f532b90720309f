"""Profiler capture helper.

The reference never got past wall-clock timing ("TODO use events",
`test/test-gpu-obj.lua:268`).  This wraps `jax.profiler` so a solve can
be captured for TensorBoard / Perfetto with one context manager:

    from mgpoisson.bench.profile import trace
    with trace("/tmp/mg_trace"):
        mg.solve(f)

Usage: python -m mgpoisson.bench.profile [--size 1024] [--out /tmp/mg_trace]
"""

from __future__ import annotations

import argparse
import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a jax.profiler trace of the enclosed block.  Wait for
    the block's results (mgpoisson.bench.timing.sync) inside it, or the
    trace stops before the device work it queued has run."""
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--out", default="/tmp/mg_trace")
    args = p.parse_args(argv)

    from mgpoisson import MultigridPoisson, Spec
    from mgpoisson.bench.timing import sync

    spec = Spec(size=args.size, dtype="float32", scheme="tuned",
                stop="residual", tol=1e-8)
    mg = MultigridPoisson(spec)
    f = mg.rhs()
    res = mg.solve(f)          # compile outside the capture
    sync(res.psi)
    with trace(args.out):
        res = mg.solve(f, psi0=mg.init_state(f))
        sync(res.psi)
    print(f"trace written to {args.out} ({res.iterations} cycles)")


if __name__ == "__main__":
    main()
