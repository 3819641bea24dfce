"""Multi-host bring-up and scaling measurement helpers.

The reference is single-process (SURVEY §2.4); the scale-out path runs the
receiver bank over all devices of one or several hosts:

- ``initialize()``: `jax.distributed` bring-up (coordinator from env vars —
  standard JAX multi-host convention). On a single host it is a no-op.
- ``measure_scaling()``: per-chip throughput of the sharded receiver bank at
  increasing device counts; scaling efficiency = rate_per_chip(N) /
  rate_per_chip(1). The channel axis is embarrassingly parallel and the time
  axis exchanges only fixed-size halos, so efficiency should stay
  near 1 as long as block sizes keep the halo fraction small
  (halo = pad_tail ~ max packet extent; choose block >> halo).
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np

__all__ = ["initialize", "measure_scaling"]


def initialize() -> bool:
    """Initialize jax.distributed from the environment if configured.

    Set ``PM_COORDINATOR`` (host:port), ``PM_NUM_PROCESSES`` and
    ``PM_PROCESS_ID`` on each host. Returns True if distributed mode is on.
    """
    coord = os.environ.get("PM_COORDINATOR")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["PM_NUM_PROCESSES"]),
        process_id=int(os.environ["PM_PROCESS_ID"]),
    )
    return True


def measure_scaling(
    signal_per_channel: np.ndarray,
    device_counts=(1, None),
    channels_per_device: int = 8,
    iters: int = 10,
    rx_config=None,
):
    """Measure receiver-bank samples/s/chip at several device counts.

    Returns a list of dicts {devices, samples_per_sec, per_chip, efficiency}.
    """
    from ..models.receiver import RxConfig
    from ..utils.cplx import to_device
    from .bank import BankConfig, ReceiverBank, make_mesh

    rx_config = rx_config or RxConfig(max_payload_len=256, max_detections=16)
    results = []
    base_per_chip = None
    all_devices = len(jax.devices())
    seen = set()
    for n in device_counts:
        n = n or all_devices
        if n > all_devices or n in seen:
            # a repeated device count measures nothing: two 1-device runs
            # reporting "efficiency of itself" is not scaling evidence
            # — skip instead of emitting a fake point
            continue
        seen.add(n)
        mesh = make_mesh(n)
        ch = channels_per_device * mesh.devices.shape[0]
        block = signal_per_channel.size
        bank = ReceiverBank(
            mesh, BankConfig(num_channels=ch, block_samples=block, rx=rx_config)
        )
        x = np.tile(signal_per_channel[None], (ch, 1))
        xj = jax.device_put(to_device(x), bank.sharding())
        out = bank.step(xj)
        jax.block_until_ready(out.accepted)
        t0 = time.time()
        for _ in range(iters):
            out = bank.step(xj)
        jax.block_until_ready(out.accepted)
        dt = (time.time() - t0) / iters
        sps = ch * block / dt
        per_chip = sps / n
        if base_per_chip is None:
            base_per_chip = per_chip
        results.append(
            {
                "devices": n,
                "samples_per_sec": sps,
                "per_chip": per_chip,
                "efficiency": per_chip / base_per_chip,
            }
        )
    return results
