#!/usr/bin/env python3
"""End-to-end serving demo: a sharded multi-channel receiver bank decoding
continuous traffic with rate monitoring.

Combines the pieces a production deployment uses: `ReceiverBank` (channels x
time sharded over the device mesh with ppermute halos), per-step rate
reporting (`ProbeRate`, probe_rate.hpp) and packet accounting — the
batched analogue of running N `packet_receiver` flowgraphs at once.

Run on the CPU with:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 PM_PLATFORM=cpu \
      python examples/receiver_bank_serving.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()  # PM_PLATFORM backend override + persistent compile cache

import jax
import numpy as np

from gr4_packet_modem_tpu.models.channel import awgn, rotate
from gr4_packet_modem_tpu.models.receiver import RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.parallel.bank import BankConfig, ReceiverBank, make_mesh
from gr4_packet_modem_tpu.runtime.flow import ProbeRate
from gr4_packet_modem_tpu.utils.cplx import to_device
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

BLOCK = 1 << 14
STEPS = 4

mesh = make_mesh()
n_dev = mesh.devices.size
channels = max(8, 2 * n_dev)
print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
      f"({n_dev} devices), {channels} channels")

# synthesize per-channel traffic: repeating bursts, per-channel CFO
tx = Transmitter(TxConfig(max_payload_len=256))
rng = np.random.default_rng(0)
payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (200, 64, 133)]
batch = PacketBatch.from_list(payloads, max_len=256)
s, l = tx.modulate_bursts(batch)
stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
burst = np.asarray(stream)
one = np.tile(burst, BLOCK * STEPS // burst.size + 1)[: BLOCK * STEPS]
x = np.zeros((channels, BLOCK * STEPS), np.complex64)
for c in range(channels):
    xc = rotate(jax.numpy.asarray(one), 0.002 * (c % 5 - 2))
    x[c] = np.asarray(awgn(jax.random.PRNGKey(c), xc, 0.05))

bank = ReceiverBank(
    mesh,
    BankConfig(
        num_channels=channels,
        block_samples=BLOCK * STEPS,
        rx=RxConfig(max_payload_len=256, max_detections=32),
    ),
)
probe = ProbeRate(alpha=0.3)
probe.update(0)  # prime the probe's clock (first call only records time)
xj = jax.device_put(to_device(x), bank.sharding())

t0 = time.time()
res = bank.step(xj)
jax.block_until_ready(res.accepted)
accepted = np.asarray(res.accepted)
lens = np.asarray(res.lengths)
report = probe.update(channels * BLOCK * STEPS)
per_ch = accepted.reshape(channels, -1).sum(axis=1)
print(f"decoded {int(accepted.sum())} packets across {channels} channels "
      f"in {time.time()-t0:.1f}s (incl. compile)")
print("per-channel packet counts:", per_ch.tolist())
if report:
    print(f"probe: rate_avg={report.rate_avg:,.0f} samples/s")
expected = len(payloads) * (BLOCK * STEPS // burst.size)
assert int(per_ch.min()) >= expected - len(payloads), per_ch
print("OK")
