"""Benchmark: full RX chain throughput on the accelerator.

Mirrors the reference's headline benchmark (benchmarks/benchmark_packet_receiver
with 4 syncword frequency bins, results.md:43-51: 6-8 Msps on a Ryzen 7 5800X),
but harder: instead of an idle stream, the receiver is fed continuous
back-to-back 1500-byte packet bursts, so every block exercises acquisition,
header decode, Costas tracking and payload decode. The metric is complex
samples/sec aggregated over a channel bank processed by one device.

Runs on the GPU (JAX's default platform); ``PM_PLATFORM=cpu`` is the explicit
way to run it on the CPU, and every result names the device it ran on.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

BASELINE_RX_SPS = 7.0e6  # reference full RX, 4 freq bins (results.md:43-51)
PAYLOAD_LEN = 1500
MAX_PAYLOAD_LEN = 1536
NUM_PAYLOADS = 12


@dataclass
class Stimulus:
    """Saturated back-to-back bursts: one pattern of ``NUM_PAYLOADS``
    1500-byte bursts (``stream``), tiled to ``block`` samples (``signal``)."""

    payloads: list
    stream: np.ndarray
    signal: np.ndarray
    block: int
    pkts_per_block: int  # complete bursts inside ``signal``
    max_det: int         # detection cap per channel and block
    budget_per_ch: int   # result-wire rows per channel and block

    def unit(self) -> np.ndarray:
        """Whole patterns covering at least one block (the serving drivers
        are fed whole bursts only)."""
        return np.ascontiguousarray(
            np.tile(self.stream, max(1, -(-self.block // self.stream.size)))
        )

    def pkts_per_unit(self) -> int:
        return len(self.payloads) * (self.unit().size // self.stream.size)


def make_stimulus(block: int, seed: int = 0, max_det: int | None = None):
    from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu.utils.cplx import to_host
    from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

    tx = Transmitter(TxConfig(max_payload_len=MAX_PAYLOAD_LEN))
    rng = np.random.default_rng(seed)
    payloads = [
        rng.integers(0, 256, PAYLOAD_LEN, dtype=np.uint8)
        for _ in range(NUM_PAYLOADS)
    ]
    batch = PacketBatch.from_list(payloads, max_len=MAX_PAYLOAD_LEN)
    s, l = tx.modulate_bursts(batch)
    lens = np.asarray(l)
    stream, _ = ragged_concat(s, l, int(lens.sum()))
    stream = to_host(stream)
    reps = block // stream.size + 1
    signal = np.tile(stream, reps)[:block]
    # count packets whose full burst fits inside the block (the tail packet
    # may be truncated mid-burst and is not expected to decode)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    starts = (
        offsets[None, :] + (np.arange(reps) * stream.size)[:, None]
    ).ravel()
    ends = starts + np.tile(lens, reps)
    # detection cap: packets that can start per block (incl. the truncated
    # tail burst) + 2 slots of headroom, rounded up to a multiple of 4. The
    # decode passes' cost is row-linear in this cap, and dropping a real
    # packet is caught by decoded_frac / the overflow parity gates; ceil
    # already counts a burst starting in the block's final samples
    pkts_ub = -(-block * len(payloads) // stream.size)
    if max_det is None:
        max_det = max(16, -(-(pkts_ub + 2) // 4) * 4)
    return Stimulus(
        payloads=payloads,
        stream=stream,
        signal=signal,
        block=block,
        pkts_per_block=int(np.count_nonzero(ends <= block)),
        max_det=max_det,
        # result-wire compaction budget (accepted-first rows shipped per
        # block, see runtime.streaming.pack_result_wire): per-channel
        # packets per block + headroom
        budget_per_ch=min(max_det, pkts_ub + 4),
    )


def rx_config(stim: Stimulus, carrier: str = "vv", acq_backend: str = "auto",
              **kw):
    from gr4_packet_modem_tpu.models.receiver import RxConfig

    return RxConfig(
        max_payload_len=MAX_PAYLOAD_LEN,
        max_detections=stim.max_det,
        freq_bins=4,
        payload_carrier=carrier,
        acquisition_backend=acq_backend,
        **kw,
    )


def channel_rotation(c: int) -> complex:
    """Per-channel carrier phase of the bank stimulus."""
    return np.exp(1j * 0.1 * c)


def bank_input(stim: Stimulus, channels: int, rx) -> np.ndarray:
    """Resident bank buffer ``[C, front_pad + block + pad_tail]``."""
    fp, pt = rx.front_pad, rx.pad_tail()
    x = np.zeros((channels, fp + stim.block + pt), np.complex64)
    for c in range(channels):
        x[c, fp : fp + stim.block] = stim.signal * channel_rotation(c)
    return x


def serve(driver, x_unit: np.ndarray, pkts_per_unit: int, iters: int) -> dict:
    """Feed ``1 + iters`` units through a host-fed serving driver
    (StreamingReceiver / StreamingBank / StreamingShardedBank) and apply the
    parity gate: the rate counts only if every expected packet decoded and no
    block saturated the detection cap or the result budget — a throughput
    number with silent packet loss is not evidence."""
    channels = 1 if x_unit.ndim == 1 else x_unit.shape[0]
    n_pkts = len(driver.process(x_unit))  # warm-up/compile
    blocks0 = driver.stats["blocks"]
    stats0 = dict(driver.stats)  # steady-state deltas (exclude compile)
    t0 = time.time()
    for _ in range(iters):
        n_pkts += len(driver.process(x_unit))
    n_pkts += len(driver._drain())  # materialize the pipelined tail
    dt = time.time() - t0
    blocks_timed = driver.stats["blocks"] - blocks0
    stats1 = dict(driver.stats)
    n_pkts += len(driver.flush())  # decode the final blocks' lookahead
    expected = pkts_per_unit * channels * (1 + iters)
    parity_ok = (
        n_pkts == expected
        and driver.overflow_blocks == 0
        and driver.budget_overflow_blocks == 0
    )
    nb = max(blocks_timed, 1)
    per_block = lambda k: 1e3 * (stats1[k] - stats0[k]) / nb
    return {
        "sps": blocks_timed * driver.block * channels / dt if parity_ok else 0.0,
        "parity_ok": parity_ok,
        "expected_pkts": expected,
        "decoded_pkts": n_pkts,
        "overflow_blocks": driver.overflow_blocks,
        "budget_overflow_blocks": driver.budget_overflow_blocks,
        "h2d_ms_per_block": per_block("h2d_s"),
        "dispatch_ms_per_block": per_block("dispatch_s"),
        "materialize_ms_per_block": per_block("materialize_s"),
    }


def wire_dtype(name: str):
    import jax.numpy as jnp

    return {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8,
            "int4": "int4"}[name]


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    import jax

    from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

    # persistent compilation cache + PM_PLATFORM backend override
    _pm_setup()

    from gr4_packet_modem_tpu.models.receiver import Receiver
    from gr4_packet_modem_tpu.utils.cplx import to_device

    dev = device_info()
    if dev["platform"] != "gpu" and not os.environ.get("PM_PLATFORM"):
        sys.exit(f"bench.py: no GPU found (JAX platform {dev['platform']!r}); "
                 "set PM_PLATFORM=cpu to run it on the CPU explicitly")

    # default = the 64-channel north-star bank config (BASELINE.md); the
    # channel-group pipeline (group=16) bounds the working set at any width
    channels = int(os.environ.get("BENCH_CHANNELS", "64"))
    block = int(os.environ.get("BENCH_BLOCK", str(1 << 19)))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    # payload carrier tracking: the feed-forward V&V estimator (PER parity
    # with the costas loop is asserted by
    # tests/test_per_snr.py::test_vv_costas_per_parity); set
    # BENCH_CARRIER=costas for the loop-exact reference behavior
    carrier = os.environ.get("BENCH_CARRIER", "vv")
    # acquisition backend: auto (= fft, the reference overlap-save FFT
    # correlator), fft, conv (direct convolution)
    acq_backend = os.environ.get("BENCH_ACQ", "auto")
    maxdet_env = os.environ.get("BENCH_MAXDET")
    stim = make_stimulus(block, max_det=int(maxdet_env) if maxdet_env else None)
    max_det = stim.max_det
    cfg = rx_config(stim, carrier, acq_backend)
    rx = Receiver(cfg)
    xj = to_device(bank_input(stim, channels, rx))

    # batched bank decode with channel-group pipelining (bounds the working
    # set past 16 channels — see Receiver.bank_step)
    group = int(os.environ.get("BENCH_GROUP", "16"))

    def rx_step(samples_2d):
        det, _, res, _ = rx.bank_step(samples_2d, group)
        # consume the esn0 estimates too: without this XLA dead-code
        # eliminates the noise-estimation branch and the metric measures
        # less than the full chain
        return res.accepted.sum(), res.crc_ok.sum(), det.esn0_db.sum()

    step = jax.jit(rx_step)
    # warmup / compile
    t0 = time.time()
    acc, crc, _ = jax.block_until_ready(step(xj))
    compile_s = time.time() - t0
    acc = np.asarray(acc)
    decoded_frac = float(acc.sum()) / max(stim.pkts_per_block * channels, 1)

    t0 = time.time()
    for _ in range(iters):
        out = step(xj)
    jax.block_until_ready(out)
    dt = time.time() - t0
    sps = channels * block * iters / dt

    # result-wire budget: BENCH_BUDGET=0 disables compaction, an integer
    # overrides the per-channel budget
    bud_env = os.environ.get("BENCH_BUDGET", "auto")
    if bud_env == "0":
        budget_per_ch = None
    elif bud_env == "auto":
        budget_per_ch = stim.budget_per_ch
    else:
        budget_per_ch = int(bud_env)
    xfer = os.environ.get("BENCH_XFER", "int8")
    transfer_dtype = wire_dtype(xfer)
    bank_ch = int(os.environ.get("BENCH_BANK_CHANNELS", "8"))
    bank_group = 16 if bank_ch > 16 and bank_ch % 16 == 0 else 0
    x_unit = stim.unit()
    x_bank = np.stack(
        [x_unit * channel_rotation(c) for c in range(bank_ch)]
    ).astype(np.complex64)

    def prefixed(prefix, info, keys):
        return {f"{prefix}_{k}": info[k] for k in keys}

    # sustained end-to-end single-stream rate through the pipelined
    # StreamingReceiver host driver (h2d upload + step + deferred host
    # materialization per block), vs the resident-buffer jit loop above.
    # Reduced-precision wire planes cut the h2d cost (int8 = 2 B/sample;
    # quantization floor ~42 dB, far above the 20 dB operating point — and
    # the parity gate proves decode is lossless at this wire format)
    sustained_info = {}
    sustained = 0.0
    if os.environ.get("BENCH_SUSTAINED", "1") == "1":
        from gr4_packet_modem_tpu.runtime.streaming import StreamingReceiver

        srx = StreamingReceiver(
            cfg, block=block, transfer_dtype=transfer_dtype,
            result_budget=budget_per_ch,
        )
        info = serve(srx, x_unit, stim.pkts_per_unit(), max(iters // 2, 5))
        sustained = info["sps"]
        sustained_info = {
            "sustained_xfer": xfer,
            "sustained_budget": budget_per_ch,
            **prefixed("sustained", info, (
                "parity_ok", "expected_pkts", "decoded_pkts",
                "overflow_blocks", "h2d_ms_per_block",
                "dispatch_ms_per_block", "materialize_ms_per_block")),
        }

    # sustained multi-channel serving: C channels host-fed through
    # StreamingBank — one [2, C, block] wire transfer and one compiled
    # batched step per block. Same parity gate.
    bank_sustained = 0.0
    bank_info = {}
    if os.environ.get("BENCH_BANK", "1") == "1":
        from gr4_packet_modem_tpu.runtime.streaming import StreamingBank

        bank = StreamingBank(
            cfg, channels=bank_ch, block=block, transfer_dtype=transfer_dtype,
            group=bank_group,
            result_budget=None if budget_per_ch is None
            else budget_per_ch * bank_ch,
        )
        info = serve(bank, x_bank, stim.pkts_per_unit(), max(iters // 4, 3))
        bank_sustained = info["sps"]
        bank_info = {
            "bank_channels": bank_ch,
            "bank_budget": bank.result_budget,
            **prefixed("bank_sustained", info, (
                "parity_ok", "expected_pkts", "decoded_pkts")),
            **prefixed("bank", info, (
                "h2d_ms_per_block", "dispatch_ms_per_block",
                "materialize_ms_per_block")),
        }

    # sustained serving through the sharded host-fed driver:
    # StreamingShardedBank on a (ch, time) mesh over all available devices
    # (one GPU runs the degenerate 1x1 mesh; chip_smoke.py --multi runs a
    # 2x2 mesh on four). Same parity gate.
    sharded_sustained = 0.0
    sharded_info = {}
    if os.environ.get("BENCH_SHARDED", "1") == "1":
        from gr4_packet_modem_tpu.parallel.bank import make_mesh
        from gr4_packet_modem_tpu.parallel.serving import StreamingShardedBank

        mesh = make_mesh(len(jax.devices()))
        sbank = StreamingShardedBank(
            mesh, cfg, channels=bank_ch, block=block,
            transfer_dtype=transfer_dtype, group=bank_group,
            result_budget=None if budget_per_ch is None
            else budget_per_ch * (bank_ch // mesh.devices.shape[0]),
        )
        info = serve(sbank, x_bank, stim.pkts_per_unit(), max(iters // 4, 3))
        sharded_sustained = info["sps"]
        sharded_info = {
            "sharded_mesh": list(mesh.devices.shape),
            "sharded_budget": sbank.result_budget,
            **prefixed("sharded", info, (
                "parity_ok", "expected_pkts", "decoded_pkts",
                "h2d_ms_per_block", "dispatch_ms_per_block",
                "materialize_ms_per_block")),
        }

    result = {
        "metric": "rx_chain_samples_per_sec_per_chip",
        "value": sps,
        "unit": "samples/s",
        "vs_baseline": sps / BASELINE_RX_SPS,
        "channels": channels,
        "block": block,
        "carrier": carrier,
        "acq_backend": acq_backend,
        "sustained_stream_sps": sustained,
        "bank_sustained_sps": bank_sustained,
        "sharded_bank_sustained_sps": sharded_sustained,
        "max_detections": max_det,
        "decoded_packet_frac": decoded_frac,
        "compile_s": compile_s,
        "device": dev,
        **sustained_info,
        **bank_info,
        **sharded_info,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
