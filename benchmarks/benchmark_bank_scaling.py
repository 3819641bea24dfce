#!/usr/bin/env python3
"""Receiver-bank scaling benchmark (BASELINE config #5: 64-channel bank,
channels x time sharded; measures samples/s/chip and scaling efficiency).

On a single device this reports the per-device rate only; run with
XLA_FLAGS=--xla_force_host_platform_device_count=8 PM_PLATFORM=cpu for a
virtual-mesh functional check, or on a multi-GPU host for real numbers
(PM_COORDINATOR et al. for multi-host, see parallel/multihost.py).

usage: benchmark_bank_scaling.py [channels_per_device] [block_log2]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()  # PM_PLATFORM backend override + persistent compile cache

from benchmarks.common import tiled_burst_signal
from gr4_packet_modem_tpu.models.receiver import RxConfig
from gr4_packet_modem_tpu.parallel import multihost


def main():
    ch_per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    block = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 17)
    multihost.initialize()
    sig, _ = tiled_burst_signal(total=block, max_payload_len=256, payload_len=200)
    results = multihost.measure_scaling(
        sig,
        device_counts=(1, 2, 4, None),
        channels_per_device=ch_per_dev,
        rx_config=RxConfig(max_payload_len=256, max_detections=16),
    )
    for r in results:
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in r.items()}))


if __name__ == "__main__":
    main()
