"""CI guard for the driver entry points (__graft_entry__.py).

Round 1 shipped a broken dryrun_multichip while 180 library tests
passed, because nothing imported the entry module.  These tests pin
both driver contracts:

- entry() must return a jittable fn + example args (compile-checked by
  lowering, no execution of the 1024^2 program needed), and
- dryrun_multichip(n) must self-provision its virtual device mesh and
  pass end-to-end even from a process that has NOT set
  --xla_force_host_platform_device_count.
"""

import os
import subprocess
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_entry_lowers():
    from __graft_entry__ import entry

    fn, args = entry()
    lowered = jax.jit(fn).lower(*args)
    assert lowered is not None


def test_dryrun_multichip_inline():
    # conftest provisions 8 virtual CPU devices -> the inline path runs
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_dryrun_multichip_self_provisions():
    """Simulate the driver: a process with NO forced device count and no
    JAX_PLATFORMS=cpu must still pass via the subprocess fallback."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    code = (
        f"import sys; sys.path.insert(0, {REPO!r})\n"
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(4)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
