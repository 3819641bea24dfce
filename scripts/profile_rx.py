#!/usr/bin/env python3
"""Per-stage RX pipeline profiler (supported tooling, not a .debug scratch).

Times each receiver stage cumulatively over the bench.py workload —
acquire | +headers | +filter | +payload(vv) | +payload(costas) — and prints
one JSON line per stage; per-stage cost is the difference between
consecutive lines. Equivalent role to the reference's ``-DTRACE`` build +
ProbeRate instrumentation (SURVEY §5), adapted to compiled-block profiling.

Options (env):
  BENCH_CHANNELS / BENCH_BLOCK / BENCH_ITERS   workload shape
  PROF_CARRIER   vv|costas for the full-chain line (default: both)
  PROF_TRACE     directory -> dump a jax.profiler trace of one full step
                 (view with tensorboard or xprof)
  PM_PLATFORM    backend override (cpu for smoke runs on the CPU)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()


def main():
    from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu.utils.cplx import to_device, to_host
    from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

    channels = int(os.environ.get("BENCH_CHANNELS", "8"))
    block = int(os.environ.get("BENCH_BLOCK", str(1 << 18)))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    carriers = (
        [os.environ["PROF_CARRIER"]]
        if os.environ.get("PROF_CARRIER")
        else ["vv", "costas"]
    )

    tx = Transmitter(TxConfig(max_payload_len=1536))
    rng = np.random.default_rng(0)
    payloads = [
        rng.integers(0, 256, 1500, dtype=np.uint8) for _ in range(12)
    ]
    batch = PacketBatch.from_list(payloads, max_len=1536)
    s, l = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
    stream = to_host(stream)
    signal = np.tile(stream, block // stream.size + 1)[:block]

    acq_backend = os.environ.get("BENCH_ACQ", "fft")

    def build(carrier):
        return Receiver(
            RxConfig(
                max_payload_len=1536,
                max_detections=32,
                freq_bins=4,
                payload_carrier=carrier,
                acquisition_backend=acq_backend,
            )
        )

    rx = build("vv")
    fp, pt = rx.front_pad, rx.pad_tail()
    x = np.zeros((channels, fp + block + pt), np.complex64)
    for c in range(channels):
        x[c, fp : fp + block] = signal * np.exp(1j * 0.1 * c)
    xj = to_device(x)

    def stage_fn(rx, upto):
        # lane-packed bank path (decode_bank): acquisition vmapped per
        # channel, decode truncated at the requested stage
        def step(s2d):
            det = jax.vmap(lambda xc: rx.acquirer.acquire(xc))(s2d)
            if upto == "acquire":
                return det.valid.sum()
            outs = rx.decode_bank(s2d, det, upto)
            if upto == "headers":
                return outs[1].header_ok.sum()
            if upto == "filter":
                return outs[2].sum()
            return outs[2].accepted.sum()

        return jax.jit(step)

    stages = [("acquire", stage_fn(rx, "acquire")),
              ("headers", stage_fn(rx, "headers")),
              ("filter", stage_fn(rx, "filter"))]
    for c in carriers:
        stages.append((f"full_{c}", stage_fn(build(c), "full")))

    for name, fn in stages:
        t0 = time.time()
        out = jax.block_until_ready(fn(xj))
        compile_s = time.time() - t0
        t0 = time.time()
        for _ in range(iters):
            out = fn(xj)
        out = jax.block_until_ready(out)
        dt = (time.time() - t0) / iters
        print(
            json.dumps(
                {
                    "stage": name,
                    "ms_per_step": round(dt * 1e3, 3),
                    "msps": round(channels * block / dt / 1e6, 1),
                    "compile_s": round(compile_s, 1),
                    "check": int(np.asarray(out).sum()),
                }
            ),
            flush=True,
        )

    trace_dir = os.environ.get("PROF_TRACE")
    if trace_dir:
        full = stages[-1][1]
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(full(xj))
        print(json.dumps({"trace": trace_dir}), flush=True)


if __name__ == "__main__":
    main()
