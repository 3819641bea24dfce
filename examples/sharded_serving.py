#!/usr/bin/env python3
"""Host-fed sharded serving: StreamingShardedBank on a (ch, time) mesh.

The production serving path: the host streams `[C, n]` sample
blocks onto the device mesh — each device receives only its (ch, time)
slice of the int8 wire, the block is reassembled on the mesh, every device
decodes its own time shard with the in-packet suppression state chained
across shards AND blocks, and results come back compacted to the accepted
packets. Per-packet RX debug logging (`log=True`) mirrors the reference's
`PayloadMetadataInsert{log:true}` (payload_metadata_insert.hpp:66).

Run on the CPU with:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 PM_PLATFORM=cpu \
      python examples/sharded_serving.py
"""

import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()  # PM_PLATFORM backend override + persistent compile cache

import jax
import jax.numpy as jnp
import numpy as np

from gr4_packet_modem_tpu.models.channel import awgn, rotate
from gr4_packet_modem_tpu.models.receiver import RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.parallel.bank import make_mesh
from gr4_packet_modem_tpu.parallel.serving import StreamingShardedBank
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")

BLOCK = 1 << 12

mesh = make_mesh()
ch_shards, t_shards = mesh.devices.shape
channels = ch_shards
print(f"mesh: {ch_shards} ch x {t_shards} time shards "
      f"({mesh.devices.size} devices), {channels} channels")

# per-channel traffic: repeating bursts with per-channel CFO + noise
tx = Transmitter(TxConfig(max_payload_len=128))
rng = np.random.default_rng(0)
ch_payloads = [
    [rng.integers(0, 256, n, dtype=np.uint8) for n in (100, 64, 128)]
    for _ in range(channels)
]
x = np.zeros((channels, 3 * BLOCK), np.complex64)
for c, payloads in enumerate(ch_payloads):
    batch = PacketBatch.from_list(payloads, max_len=128)
    s, l = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
    sig = rotate(jnp.asarray(stream), 0.002 * (c + 1))
    sig = np.asarray(awgn(jax.random.PRNGKey(c), sig, 0.05))
    off = 200 + 900 * c
    x[c, off : off + sig.size] = sig

bank = StreamingShardedBank(
    mesh,
    RxConfig(max_payload_len=128, max_detections=4, freq_bins=1),
    channels=channels,
    block=BLOCK,
    transfer_dtype=jnp.int8,   # 2 B/sample h2d wire
    result_budget=4,           # compacted d2h: accepted rows only
    log=True,                  # per-packet RX debug lines
)
pkts = bank.process(x) + bank.flush()

expected = sum(len(p) for p in ch_payloads)
print(f"decoded {len(pkts)}/{expected} packets on the mesh "
      f"(overflow blocks: {bank.overflow_blocks}, "
      f"budget overflow: {bank.budget_overflow_blocks})")
assert len(pkts) == expected
