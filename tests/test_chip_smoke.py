"""chip_smoke.py at a tiny geometry on the CPU: the stimulus, the bank and
serving parity gates, the phases that compare two devices (here two virtual
CPU devices), the --multi path on a virtual (2, 2) mesh, the last line's
shape, and the non-zero exit where there is no GPU or no repo."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke as cs
from bench import make_stimulus, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 1 << 16


@pytest.fixture(scope="module")
def stim():
    return make_stimulus(BLOCK)


@pytest.fixture(scope="module")
def bank_out(stim):
    """One decoded 2-channel block: (det, res) of the resident bank step."""
    import jax.numpy as jnp

    from bench import bank_input, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver

    rx = Receiver(rx_config(stim, "vv"))
    det, _, res, _ = rx.bank_step(jnp.asarray(bank_input(stim, 2, rx)), 0)
    return jax.tree.map(np.asarray, (det, res))


def test_stimulus_geometry(stim):
    assert stim.signal.shape == (BLOCK,)
    assert stim.max_det >= 16 and stim.max_det % 4 == 0
    assert 0 < stim.pkts_per_block <= stim.max_det
    assert stim.budget_per_ch <= stim.max_det
    unit = stim.unit()
    assert unit.size >= BLOCK and unit.size % stim.stream.size == 0
    assert stim.pkts_per_unit() == len(stim.payloads) * (
        unit.size // stim.stream.size
    )
    # the block is the stream pattern tiled
    np.testing.assert_array_equal(
        stim.signal[: stim.stream.size], stim.stream[:BLOCK]
    )


def test_check_bank_accepts_decoded_block(stim, bank_out):
    det, res = bank_out
    out = cs.check_bank(stim, 2, det, res)
    assert out["decoded_pkts"] == out["expected_pkts"] == 2 * stim.pkts_per_block


def test_check_bank_rejects_missing_packet(stim, bank_out):
    det, res = bank_out
    acc = res.accepted.copy()
    acc[np.nonzero(acc)[0][0]] = False
    with pytest.raises(cs.SmokeFailure, match="packets"):
        cs.check_bank(stim, 2, det, dataclasses.replace(res, accepted=acc))


def test_check_bank_rejects_corrupt_byte(stim, bank_out):
    det, res = bank_out
    data = res.data.copy()
    data[np.nonzero(res.accepted)[0][-1], 7] ^= 1
    with pytest.raises(cs.SmokeFailure, match="bytes differ"):
        cs.check_bank(stim, 2, det, dataclasses.replace(res, data=data))


def test_check_bank_rejects_overflow(stim, bank_out):
    det, res = bank_out
    det = dataclasses.replace(det, overflow=np.bool_(True))
    with pytest.raises(cs.SmokeFailure, match="overflow"):
        cs.check_bank(stim, 2, det, res)


class _LossyDriver:
    """A serving driver that decodes one packet fewer than it was fed."""

    block = BLOCK

    def __init__(self, per_unit):
        self.per_unit, self.calls = per_unit, 0
        self.stats = {"blocks": 0, "h2d_s": 0.0, "dispatch_s": 0.0,
                      "materialize_s": 0.0}
        self.overflow_blocks = self.budget_overflow_blocks = 0

    def process(self, x):
        self.calls += 1
        self.stats["blocks"] += 1
        return [object()] * (self.per_unit - (self.calls == 2))

    def _drain(self):
        return []

    def flush(self):
        return []


def test_serve_parity_gate(stim):
    unit = stim.unit()
    info = serve(_LossyDriver(stim.pkts_per_unit()), unit,
                 stim.pkts_per_unit(), iters=2)
    assert not info["parity_ok"] and info["sps"] == 0.0
    assert info["decoded_pkts"] == info["expected_pkts"] - 1


def test_phase_tx_across_devices(stim):
    out = cs.phase_tx(stim, jax.devices("cpu")[1])
    assert out["max_abs_err"] <= cs.TX_ATOL


def test_phase_device_vs_device(stim):
    out = cs.phase_gpu_vs_cpu(stim, jax.devices("cpu")[1])
    assert out["accepted"] == stim.pkts_per_block


def test_phase_kernels_interpreted():
    out = cs.phase_kernels(((40, 192, 0), (33, 100, 192)), interpret=True,
                           iters=1)
    assert [o["hard_decision_flips"] for o in out] == [0, 0]


def test_phase_multi_virtual_mesh(stim):
    out = cs.phase_multi(stim, channels=4, group=0)
    assert out["mesh"] == [2, 2]
    assert out["packets"] == 4 * stim.pkts_per_block


def test_last_line_shape():
    line = cs.last_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                         "count": 1})
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert line.startswith('{"ok": true, "device": {"platform": "gpu"')


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    out = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_without_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
