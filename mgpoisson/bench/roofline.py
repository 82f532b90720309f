"""Per-kernel bandwidth roofline report.

The reference only ever wall-clocks whole runs and left OpenCL event
timing as a TODO (`test/test-gpu-obj.lua:268`).  Here every hot op is
timed individually (overhead-cancelled chained timing) and reported as
achieved GB/s against the card's HBM peak from PEAKS.

Usage: python -m mgpoisson.bench.roofline [--size 4096] [--dtype float32]
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from mgpoisson.bench.timing import chain_time

# Published peaks by jax Device.device_kind.  Source: NVIDIA H100 Tensor
# Core GPU data sheet, SXM5 part (80 GB HBM3 at 3.35 TB/s; 67 TFLOP/s
# float32 outside the tensor cores), at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0},
}


def hbm_peak_gbps(device_kind: str) -> float:
    """HBM peak of a device kind; a device not in PEAKS is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peak for device {device_kind!r}; "
                       "add it to mgpoisson.bench.roofline.PEAKS")
    return PEAKS[device_kind]["hbm_gbps"]


def report(size: int = 4096, dtype: str = "float32", nu: int = 2):
    from mgpoisson import Spec
    from mgpoisson.cycle.vcycle import v_cycle
    from mgpoisson.kernels import get_ops

    spec = Spec(size=size, dtype=dtype, scheme="tuned", backend="auto",
                pre_smooth=nu, post_smooth=nu)
    ops = get_ops(spec, size)
    h = spec.fine_h
    itemsize = jnp.dtype(dtype).itemsize
    cells = size * size
    dev = jax.devices()[0]
    # device metrics only on the GPU; a CPU run reports times alone
    peak = hbm_peak_gbps(dev.device_kind) if dev.platform == "gpu" \
        else None

    f = jnp.zeros((size, size), jnp.dtype(dtype)) \
        .at[size // 2, size // 2].set(-1e6)
    u = -f
    V = jnp.zeros((size // 2, size // 2), jnp.dtype(dtype))

    # (label, fn(carry, f, V, zero), minimal HBM bytes per application).
    # Every fn's operands are data-dependent on the chained carry — a
    # constant operand would be loop-invariant-hoisted out of the
    # timing scan — and f/V are passed as chain_time consts, NOT closed
    # over (see bench/timing.py).  The runtime zero
    # `z` ties discarded outputs into the carry so XLA cannot
    # dead-code-eliminate them.
    entries = [
        (f"smooth wjacobi x{nu} (fused)",
         lambda c, ff, VV, z: ops.smooth(c, ff, h, nu, "wjacobi",
                                         "ghost0"),
         3 * cells * itemsize),
        (f"smooth rbgs x{nu} (fused)",
         lambda c, ff, VV, z: ops.smooth(c, ff, h, nu, "rbgs", "ghost0"),
         3 * cells * itemsize),
        (f"smooth jacobi x{nu} (fused)",
         lambda c, ff, VV, z: ops.smooth(c, ff, h, nu, "jacobi",
                                         "ghost0"),
         3 * cells * itemsize),
        # the two fused half-levels exactly as the V-cycle runs them
        (f"smooth x{nu} + residual + restrict (fused)",
         lambda c, ff, VV, z: (lambda ur: ur[0].at[0, 0].add(
             z * ur[1][0, 0]))(
             ops.smooth_residual_restrict(c, ff, h, nu, "wjacobi",
                                          "ghost0")),
         (3 * cells + cells // 4) * itemsize),
        (f"prolong + correct + smooth x{nu} (fused)",
         lambda c, ff, VV, z: ops.prolong_correct_smooth(
             c, ff, VV, h, nu, "wjacobi", "ghost0", "bilinear"),
         (3 * cells + cells // 4) * itemsize),
        # the unfused transfer-op round trip (for comparison)
        ("residual_restrict + prolong_correct (bilinear)",
         lambda c, ff, VV, z: ops.prolong_correct(
             c, ops.residual_restrict(c, ff, h, "ghost0"), "bilinear"),
         (3 * cells + 2 * (cells // 4)) * itemsize),
        ("full V-cycle (tuned)",
         lambda c, ff, VV, z: v_cycle(c, ff, h, spec),
         None),
    ]

    z = jnp.zeros((), jnp.dtype(dtype))
    rows = []
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"size={size} dtype={dtype} peak={peak} GB/s")
    print(f"{'op':40s} {'ms':>9s} {'GB/s':>9s} {'% peak':>8s}")
    for label, fn, nbytes in entries:
        t = chain_time(fn, u, consts=(f, V, z))
        gbps = nbytes / t / 1e9 if nbytes else None
        pct = 100 * gbps / peak if (gbps and peak) else None
        rows.append({"op": label, "seconds": t, "gbps": gbps,
                     "pct_peak": pct})
        print(f"{label:40s} {t * 1e3:9.3f} "
              f"{gbps if gbps else float('nan'):9.1f} "
              f"{pct if pct else float('nan'):8.1f}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--nu", type=int, default=2)
    args = p.parse_args(argv)
    report(args.size, args.dtype, args.nu)


if __name__ == "__main__":
    main()
