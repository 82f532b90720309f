"""Multi-host execution smoke test: 2 CPU processes via jax.distributed.

The reference is single-process (SURVEY.md section 2.3); this exercises
the scale-out path `mgpoisson.shard.multihost` plans — a global mesh
spanning processes, per-process local data assembly, and a sharded
multigrid step whose collectives cross the process boundary (Gloo on
CPU; NCCL between GPU hosts).  Each worker also checks value parity
of its addressable shards against an unsharded single-device step.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, {repo!r})
from mgpoisson.shard import multihost

multihost.initialize(coordinator_address=f"localhost:{{port}}",
                     num_processes=nproc, process_id=pid)
import numpy as np
from mgpoisson import MultigridPoisson, Spec

assert jax.process_count() == nproc
mesh = multihost.global_mesh()          # (2, 2) over 2 procs x 2 devices
assert mesh.devices.size == 4

size = 16
spec = Spec(size=size, dtype="float32", scheme="tuned", backend="xla",
            maxiter=4, replicate_below=4)
f_np = np.zeros((size, size), np.float32)
f_np[size // 2, size // 2] = -1e6

# global f from process-local row blocks (process p owns rows p*8..p*8+8)
rows = size // nproc
f = multihost.make_global_array(f_np[pid * rows:(pid + 1) * rows, :],
                                mesh, spec)
assert f.shape == (size, size)

mg = MultigridPoisson(spec, mesh=mesh)
psi, err = mg.step(-f, f)
err_f = float(err)
assert np.isfinite(err_f)

# value parity: every addressable shard matches the unsharded step.
# f32 cross-path tolerance (3e-5, scaled): the spmd step's psum and
# deep-halo orders differ from the single-device reduction order
mg1 = MultigridPoisson(spec)
import jax.numpy as jnp
psi_ref, err_ref = mg1.step(jnp.asarray(-f_np), jnp.asarray(f_np))
psi_ref = np.asarray(psi_ref)
scale = float(np.max(np.abs(psi_ref))) or 1.0
for shard in psi.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data),
                               psi_ref[shard.index], rtol=3e-5,
                               atol=3e-5 * scale)
assert abs(err_f - float(err_ref)) <= 1e-5 * max(abs(float(err_ref)), 1.0)

# 3D: the grid shards axes (0, 1) over ('x', 'y'), axis 2 local —
# make_global_array must emit P('x', 'y', None) for rank-3 blocks
size3 = 8
spec3 = Spec(size=size3, ndim=3, dtype="float32", scheme="tuned",
             backend="xla", maxiter=2, replicate_below=4)
f3_np = np.zeros((size3,) * 3, np.float32)
f3_np[(size3 // 2,) * 3] = -1e6
rows3 = size3 // nproc
f3 = multihost.make_global_array(f3_np[pid * rows3:(pid + 1) * rows3],
                                 mesh, spec3)
assert f3.shape == (size3,) * 3
mg3 = MultigridPoisson(spec3, mesh=mesh)
psi3, err3 = mg3.step(-f3, f3)
assert np.isfinite(float(err3))
psi3_ref, err3_ref = MultigridPoisson(spec3).step(
    jnp.asarray(-f3_np), jnp.asarray(f3_np))
psi3_ref = np.asarray(psi3_ref)
scale3 = float(np.max(np.abs(psi3_ref))) or 1.0
for shard in psi3.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data),
                               psi3_ref[shard.index], rtol=3e-5,
                               atol=3e-5 * scale3)

print(f"proc {{pid}} OK err={{err_f}}")
""".format(repo=REPO)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_step(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("PYTEST_CURRENT_TEST", None)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), "2",
                          str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out[-3000:]}"
        assert "OK err=" in out
