"""Device timing by chained applications.

`chain_time` runs the function K times chained inside one jit (via
lax.scan) at two different K and reports the MEDIAN of per-application
time differences: the fixed dispatch and launch overhead cancels, and
the median avoids the downward bias a best-of would have on noisy
differences.  `jax.block_until_ready` waits for the device, so it ends
every timed region.

The chained operand must be data-dependent on the scan carry or XLA
hoists it out of the loop and the op is measured zero times.
"""

from __future__ import annotations

import time

import jax


def sync(out) -> None:
    """Wait until every array in `out` has been computed."""
    jax.block_until_ready(out)


def chain_time(fn, x, k1: int = 10, k2: int = 60, tries: int = 5,
               consts=()) -> float:
    """Median per-application seconds of x -> fn(x).

    Extra operands the caller would otherwise close over (the RHS f,
    a coarse V, ...) can be passed via consts=(...) and are forwarded to
    fn(c, *consts).  Pass large arrays THIS way: a closed-over device
    array becomes a constant baked into the compiled program."""

    def rep(k):
        @jax.jit
        def g(x, *cs):
            def body(c, _):
                return fn(c, *cs), None
            c, _ = jax.lax.scan(body, x, None, length=k)
            return c
        return g

    g1, g2 = rep(k1), rep(k2)
    sync(g1(x, *consts))
    sync(g2(x, *consts))
    samples = []
    for _ in range(tries):
        t0 = time.perf_counter()
        sync(g1(x, *consts))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        sync(g2(x, *consts))
        t2 = time.perf_counter() - t0
        samples.append((t2 - t1) / (k2 - k1))
    samples.sort()
    return samples[len(samples) // 2]
