#!/usr/bin/env python3
"""Minimal end-to-end loopback: TX -> channel -> RX, print decode results."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()  # PM_PLATFORM backend override + persistent compile cache

import jax
import numpy as np

from gr4_packet_modem_tpu.models.channel import awgn, rotate
from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

payloads = [np.frombuffer(s, np.uint8) for s in (b"hello", b"jax packet modem")]

tx = Transmitter(TxConfig(max_payload_len=64))
batch = PacketBatch.from_list(payloads, max_len=64)
samples, lens = tx.modulate_bursts(batch)
stream, _ = ragged_concat(samples, lens, int(np.sum(np.asarray(lens))))

x = awgn(jax.random.PRNGKey(0), rotate(stream, 0.006), 0.05)

rx = Receiver(RxConfig(max_payload_len=64, max_detections=8))
res = rx.receive(x)
for i in np.nonzero(np.asarray(res.accepted))[0]:
    n = int(np.asarray(res.lengths)[i])
    print("decoded:", bytes(np.asarray(res.data)[i, :n]))
