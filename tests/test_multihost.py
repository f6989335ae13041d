"""Multi-host (DCN) smoke test: 2 real processes over jax.distributed.

Exercises parallel/multihost.py end-to-end: two localhost processes initialize a
jax.distributed rig (Gloo over TCP = the CPU stand-in for DCN), each voxel-
downsamples its own cameras' points locally, and only the fused clouds cross
the process boundary via process_allgather — the SURVEY.md §2.5 host<->host
tier contract.
"""
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_multihost_child.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_package_import_does_not_initialize_backend():
    """jax.distributed.initialize must run BEFORE any backend init, so the
    package (every module the __init__ chain pulls in) may not create jax
    arrays at import time. Regression guard: ops/change.py once held
    module-level jnp constants and silently broke the 2-process rig."""
    code = (
        "import os; os.environ.setdefault('JAX_PLATFORMS', 'cpu')\n"
        "import jax._src.xla_bridge as xb\n"
        "import pointcloud_stitching_tpu\n"
        "import pointcloud_stitching_tpu.parallel\n"
        "import pointcloud_stitching_tpu.runtime.wire\n"
        "assert not xb._backends, 'package import initialized the backend'\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_two_process_dcn_allgather():
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the coordinator (proc 0) must be up before proc 1 dials in; both block
    # in init until the rig is complete, so just launch both and wait
    procs = [subprocess.Popen([sys.executable, CHILD, str(i), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for i in range(2)]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"proc {i} rc={rc}\n{err[-2000:]}"
        assert f"MULTIHOST_OK {i}" in out, out
