"""2-process jax.distributed receiver-bank test.

Proves the DCN code path: ``multihost.initialize()`` brings up
``jax.distributed`` across two real OS processes (CPU backend, 2 virtual
devices each) and the sharded receiver bank decodes packets — including one
straddling the cross-process time-shard boundary — through the ppermute halo
exchange. Equivalent role to SURVEY §2.4's multi-host scaling row.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(600)
def test_two_process_distributed_bank():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env_base = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("PM_", "XLA_FLAGS", "JAX_"))
    }
    procs = []
    for pid in range(2):
        env = dict(
            env_base,
            PM_COORDINATOR=f"127.0.0.1:{port}",
            PM_NUM_PROCESSES="2",
            PM_PROCESS_ID=str(pid),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, worker],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert any("MULTIHOST_RESULT PASS" in o for o in outs), outs
