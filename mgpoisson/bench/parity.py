"""On-device parity sweep of the compiled Hopper smoother.

The interpret-mode differential tests (tests/test_smoother_diff.py)
check the kernel's semantics on the CPU; this module checks the kernel
as the GPU compiler built it, against the XLA formulation, on the card
- the reference's cross-implementation diffing (`cpu-raw.lua:120`,
debug-dump trace comparison) applied where the kernel runs.  Cases:
every smoother the kernel implements, both boundary conditions, f32
and bf16, the smoother alone and inside both half-level composites.

Run via bench.py (kernel_parity_* in the extras) or directly:
python -m mgpoisson.bench.parity
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

# per smoother, the sweep counts the schemes use (core/spec.py SCHEMES)
NUS = {"jacobi": (2, 7), "wjacobi": (3,), "rbgs": (1, 2)}


def _mkdata(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.normal(size=shape), dtype),
            jnp.asarray(rng.normal(size=shape), dtype))


def _err(got, ref):
    """Normalized max |diff|, computed on the device; only the scalar
    comes back to the host."""
    got = jnp.asarray(got, jnp.float32)
    ref = jnp.asarray(ref, jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(ref)), 1e-30)
    return float(jnp.max(jnp.abs(got - ref)) / scale)


def run_parity(sizes=(2048, 4096), interpret: bool = False,
               block=None) -> dict:
    """Returns {"max_err_f32", "worst_f32", "max_err_bf16", "n_cases",
    "cases": {name: err}, "failures": {name: message}}.

    f32 cases should agree with the XLA ops to ~1e-6 (same precision,
    another order of operations); bf16 cases are compared against the
    XLA ops run in bf16, so they measure kernel parity, not precision
    loss, and a few 1e-2 is their rounding-order noise over nu sweeps.
    `interpret` and `block` let a CPU test run the same sweep through
    the Pallas interpreter at small sizes."""
    from mgpoisson.kernels import hopper, xla

    kw = {"interpret": interpret}
    if block is not None:
        kw["block"] = block
    cases, failures = {}, {}

    def add(name, got, ref):
        """got/ref are thunks; a compile or run failure is recorded per
        case so the artifact names every broken path, not the first."""
        try:
            g, r = got(), ref()
            if isinstance(g, tuple):
                for i, (gi, ri) in enumerate(zip(g, r)):
                    cases[f"{name}[{i}]"] = _err(gi, ri)
            else:
                cases[name] = _err(g, r)
        except Exception as e:  # noqa: BLE001 - recorded per case
            failures[name] = f"{type(e).__name__}: {str(e)[:200]}"

    for n in sizes:
        h = 1.0 / n
        for dtype in (jnp.float32, jnp.bfloat16):
            dt = jnp.dtype(dtype).name
            u, f = _mkdata((n, n), dtype)
            V = _mkdata((n // 2, n // 2), dtype, seed=3)[0]
            for sm, nus in NUS.items():
                for nu in nus:
                    if not hopper.supports((n, n), dtype, sm, nu):
                        continue
                    kern = functools.partial(hopper.smooth_pallas, h=h,
                                             nu=nu, smoother=sm, **kw)
                    for bc in ("ghost0", "face"):
                        tag = f"{n}_{dt}_{sm}_nu{nu}_{bc}"
                        add(f"smooth_{tag}",
                            lambda k=kern, bc=bc: k(u, f, bc=bc),
                            lambda nu=nu, sm=sm, bc=bc:
                                xla.smooth(u, f, h, nu, sm, bc))
                    kind = "bilinear"
                    tag = f"{n}_{dt}_{sm}_nu{nu}"
                    if dtype == jnp.float32:
                        # (a bf16 residual of a smoothed iterate is all
                        # cancellation: it would measure bf16, not the
                        # kernel)
                        add(f"rr_{tag}",
                            lambda k=kern: (lambda us: (
                                us, xla.residual_restrict(us, f, h,
                                                          "face")))(
                                k(u, f, bc="face")),
                            lambda nu=nu, sm=sm:
                                xla.smooth_residual_restrict(
                                    u, f, h, nu, sm, "face"))
                    add(f"pc_{tag}",
                        lambda k=kern: k(xla.prolong_correct(u, V, kind), f,
                                         bc="ghost0"),
                        lambda nu=nu, sm=sm: xla.prolong_correct_smooth(
                            u, f, V, h, nu, sm, "ghost0", kind))

    f32 = {k: v for k, v in cases.items() if "bfloat16" not in k}
    bf16 = {k: v for k, v in cases.items() if "bfloat16" in k}
    return {"max_err_f32": max(f32.values()) if f32 else None,
            "worst_f32": max(f32, key=f32.get) if f32 else None,
            "max_err_bf16": max(bf16.values()) if bf16 else None,
            "n_cases": len(cases), "cases": cases,
            "failures": failures, "n_failures": len(failures)}


if __name__ == "__main__":
    import json
    import sys

    if jax.devices()[0].platform != "gpu":
        sys.exit("the parity sweep runs the compiled kernel; it needs a GPU")
    from mgpoisson.utils import compile_cache

    compile_cache.enable()
    out = run_parity()
    top = dict(sorted(out["cases"].items(), key=lambda kv: -kv[1])[:10])
    print(json.dumps({k: out[k] for k in ("max_err_f32", "worst_f32",
                                          "max_err_bf16", "n_cases",
                                          "failures")}
                     | {"top10": top}, indent=2))
    sys.exit(1 if out["failures"] else 0)
