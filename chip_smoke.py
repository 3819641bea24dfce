#!/usr/bin/env python3
"""Smoke test of the receiver's main path on one GPU.

Drives the system through the entry points a user calls, at the bench
geometry (64 channels x 2^19-sample blocks, 1536-byte payload bound,
4 frequency bins, saturated back-to-back 1500-byte bursts), and checks what
comes out against what was sent. One JSON object per phase, then a last line
``{"ok": true, "device": {...}}``:

  a  the card (nvidia-smi name and power limit) and the JAX device
  b  TX: Transmitter.modulate_bursts on the GPU vs the same call on the CPU
  c  the resident 64-channel bank step (vv payload carrier): every expected
     packet accepted, CRC passing, payload bytes exact, no overflow, esn0
     finite; compile time and step time
  d  the same at 16 channels with the loop-exact Costas payload carrier
  e  one channel's block through the same Receiver on the GPU and the CPU
  f  host-fed serving: StreamingReceiver, StreamingBank(8) and
     StreamingShardedBank on a 1x1 mesh, with bench.py's parity gates
  g  kernel A/B: every hand-written kernel against its plain version

``--multi`` runs only the sharded path on four GPUs: StreamingShardedBank
and ReceiverBank on a (2, 2) (ch, time) mesh at the bench geometry, compared
packet for packet with the single-device bank step.

Any failed check exits non-zero; so does a process with no GPU.

usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

CHANNELS = 64
BLOCK = 1 << 19
GROUP = 16
COSTAS_CHANNELS = 16
BANK_CHANNELS = 8
TIMING_ITERS = 10

# Phase b: TX samples are sums of at most 11 taps of unit-scale f32 values
# (RRC interpolation at full f32 precision); the GPU and the CPU sum in
# another order, so they agree to a few f32 ulps of the ~1.0 amplitude.
TX_ATOL = 1e-5
# Phase e: acquisition estimates come from f32 FFT correlations (cuFFT vs
# the CPU's FFT, different rounding) through atan2 / quadratic
# interpolation; the header Costas loop then runs as the GPU kernel against
# the CPU scan, with other sin/cos implementations and FMA contraction, and
# feeds its error back (the loop is contractive, so it stays bounded).
ACQ_PHASE_ATOL = 1e-3   # rad
ACQ_FREQ_ATOL = 1e-5    # rad/sample (bin spacing is pi/297 ~ 1.1e-2)
ESN0_ATOL_DB = 1e-2
COSTAS_PHASE_ATOL = 1e-2  # rad, after 192 tracked symbols
COSTAS_FREQ_ATOL = 1e-4   # rad/symbol
# Phase g: the kernel against the scan on the same device: same recursion,
# other sin/cos (libdevice in the kernel, XLA's own in the scan) and FMA
# contraction; the error is fed back through the loop but damped by it.
KERNEL_ATOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def last_line(dev: dict) -> str:
    return json.dumps({"ok": True, "device": dev})


def timed(fn, *args, iters: int = TIMING_ITERS) -> dict:
    """Compile time (first call) and per-call times of ``fn(*args)``,
    each ending in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    ms = 1e3 * np.asarray(times)
    return {
        "out": out,
        "compile_s": compile_s,
        "median_ms": float(np.median(ms)),
        "min_ms": float(ms.min()),
        "max_ms": float(ms.max()),
    }


def wrap(a):
    return (np.asarray(a) + np.pi) % (2 * np.pi) - np.pi


# ------------------------------------------------------------------ checks


def accepted_payloads(res, channels: int) -> list[list[np.ndarray]]:
    """Per channel, the accepted payloads in row order (rows are
    channel-major and index-sorted within a channel)."""
    acc = np.asarray(res.accepted).reshape(channels, -1)
    data = np.asarray(res.data).reshape(channels, acc.shape[1], -1)
    lens = np.asarray(res.lengths).reshape(channels, -1)
    return [
        [data[c, r, : lens[c, r]] for r in np.nonzero(acc[c])[0]]
        for c in range(channels)
    ]


def check_bank(stim, channels: int, det, res) -> dict:
    """Every complete burst of the block decoded exactly once, in order, with
    its CRC passing and its bytes exact; no overflow; esn0 finite."""
    got = accepted_payloads(res, channels)
    crc_ok = np.asarray(res.crc_ok).reshape(channels, -1)
    acc = np.asarray(res.accepted).reshape(channels, -1)
    check(bool(np.all(crc_ok[acc])), "an accepted packet failed its CRC")
    check(not bool(np.asarray(det.overflow)), "detection cap overflowed")
    valid = np.asarray(det.valid)
    esn0 = np.asarray(det.esn0_db)[valid]
    check(bool(np.all(np.isfinite(esn0))), "non-finite esn0 estimate")
    n = stim.pkts_per_block
    for c in range(channels):
        check(len(got[c]) == n, f"channel {c}: {len(got[c])}/{n} packets")
        for k, g in enumerate(got[c]):
            exp = stim.payloads[k % len(stim.payloads)]
            check(np.array_equal(g, exp), f"channel {c} packet {k}: bytes differ")
    return {
        "decoded_pkts": int(sum(len(g) for g in got)),
        "expected_pkts": n * channels,
        "esn0_db_median": float(np.median(esn0)),
    }


# ------------------------------------------------------------------ phases


def phase_tx(stim, cpu) -> dict:
    """The bench stimulus's TX call on the default device and on ``cpu``."""
    import jax

    from bench import MAX_PAYLOAD_LEN
    from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu.utils.ragged import PacketBatch

    tx = Transmitter(TxConfig(max_payload_len=MAX_PAYLOAD_LEN))
    batch = PacketBatch.from_list(stim.payloads, max_len=MAX_PAYLOAD_LEN)
    s_dev, l_dev = jax.block_until_ready(tx.modulate_bursts(batch))
    s_cpu, l_cpu = tx.modulate_bursts(jax.device_put(batch, cpu))
    check(np.array_equal(np.asarray(l_dev), np.asarray(l_cpu)),
          "TX burst lengths differ between devices")
    err = float(np.max(np.abs(np.asarray(s_dev) - np.asarray(s_cpu))))
    check(err <= TX_ATOL, f"TX max abs error {err} > {TX_ATOL}")
    return {"bursts": len(stim.payloads), "max_abs_err": err,
            "atol": TX_ATOL, "devices": [str(s_dev.devices()), str(cpu)]}


def phase_bank(stim, channels: int, carrier: str, group: int = GROUP):
    """The resident bank step at ``channels`` x block, checked and timed."""
    import jax

    from bench import bank_input, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver

    rx = Receiver(rx_config(stim, carrier))
    x = jax.device_put(bank_input(stim, channels, rx))
    step = jax.jit(lambda xs: rx.bank_step(xs, group))
    t = timed(step, x)
    det, hdr, res, _ = t.pop("out")
    summary = check_bank(stim, channels, det, res)
    sps = channels * stim.block / (t["median_ms"] * 1e-3)
    return {"channels": channels, "block": stim.block, "carrier": carrier,
            "group": group, "max_detections": stim.max_det, **summary, **t,
            "samples_per_s": sps}


def phase_gpu_vs_cpu(stim, cpu) -> dict:
    """One channel's block through the same Receiver on both devices."""
    import jax

    from bench import bank_input, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver

    rx = Receiver(rx_config(stim, "vv"))
    x = bank_input(stim, 1, rx)
    outs = []
    for dev in (jax.devices()[0], cpu):
        det, hdr, res, _ = rx.bank_step(jax.device_put(x, dev), GROUP)
        outs.append(jax.tree.map(np.asarray, (det, hdr, res)))
    (dg, hg, rg), (dc, hc, rc) = outs
    check(np.array_equal(dg.valid, dc.valid), "valid flags differ")
    v = dg.valid  # empty slots hold arbitrary estimates
    for name in ("index", "freq_bin"):
        check(np.array_equal(getattr(dg, name)[v], getattr(dc, name)[v]),
              f"detection {name} differs between GPU and CPU")
    check(np.array_equal(rg.accepted, rc.accepted), "accepted rows differ")
    acc = rg.accepted
    check(np.array_equal(rg.data[acc], rc.data[acc]), "accepted bytes differ")
    errs = {
        "acq_phase": float(np.max(np.abs(wrap(dg.phase[v] - dc.phase[v])))),
        "acq_freq": float(np.max(np.abs(dg.freq[v] - dc.freq[v]))),
        "esn0_db": float(np.max(np.abs(dg.esn0_db[v] - dc.esn0_db[v]))),
        "costas_phase": float(np.max(np.abs(wrap(hg.phase[v] - hc.phase[v])))),
        "costas_freq": float(np.max(np.abs(hg.freq[v] - hc.freq[v]))),
    }
    tol = {"acq_phase": ACQ_PHASE_ATOL, "acq_freq": ACQ_FREQ_ATOL,
           "esn0_db": ESN0_ATOL_DB, "costas_phase": COSTAS_PHASE_ATOL,
           "costas_freq": COSTAS_FREQ_ATOL}
    for k, e in errs.items():
        check(e <= tol[k], f"GPU vs CPU {k} error {e} > {tol[k]}")
    return {"detections": int(v.sum()), "accepted": int(acc.sum()),
            "max_abs_err": errs, "atol": tol}


def phase_serving(stim, iters: int = 2) -> dict:
    """The three host-fed serving drivers with bench.py's parity gates."""
    import jax.numpy as jnp

    from bench import channel_rotation, rx_config, serve
    from gr4_packet_modem_tpu.parallel.bank import make_mesh
    from gr4_packet_modem_tpu.parallel.serving import StreamingShardedBank
    from gr4_packet_modem_tpu.runtime.streaming import (
        StreamingBank,
        StreamingReceiver,
    )

    cfg = rx_config(stim, "vv")
    unit = stim.unit()
    x_bank = np.stack(
        [unit * channel_rotation(c) for c in range(BANK_CHANNELS)]
    ).astype(np.complex64)
    bud = stim.budget_per_ch
    drivers = {
        "stream": (StreamingReceiver(
            cfg, block=stim.block, transfer_dtype=jnp.int8, result_budget=bud,
        ), unit),
        "bank": (StreamingBank(
            cfg, channels=BANK_CHANNELS, block=stim.block,
            transfer_dtype=jnp.int8, group=0,
            result_budget=bud * BANK_CHANNELS,
        ), x_bank),
        "sharded_1x1": (StreamingShardedBank(
            make_mesh(1), cfg, channels=BANK_CHANNELS, block=stim.block,
            transfer_dtype=jnp.int8, group=0,
            result_budget=bud * BANK_CHANNELS,
        ), x_bank),
    }
    out = {}
    for name, (drv, xin) in drivers.items():
        info = serve(drv, xin, stim.pkts_per_unit(), iters)
        check(info["parity_ok"], f"{name}: parity gate failed: {info}")
        out[name] = info
    return out


def costas_inputs(rows: int, syms: int, seed: int = 0):
    """QPSK symbols with a small carrier offset and noise, wiped-off pilot
    first (what the receiver feeds the loop)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (rows, syms))
    clean = np.exp(1j * (np.pi / 4 + bits * np.pi / 2))
    clean[:, :64] = 1.0
    cfo = 1e-4 * rng.standard_normal((rows, 1))
    x = clean * np.exp(1j * (0.05 * rng.standard_normal((rows, 1))
                             + cfo * np.arange(syms)))
    x = x + 0.05 * (rng.standard_normal((rows, syms))
                    + 1j * rng.standard_normal((rows, syms)))
    return (x.astype(np.complex64), np.zeros(rows, np.float32),
            np.zeros(rows, np.float32))


def phase_kernels(shapes=((384, 192, 0), (1536, 192, 0), (384, 6160, 192),
                          (1536, 6160, 192)), interpret: bool = False,
                  iters: int = TIMING_ITERS) -> list:
    """The Costas kernel against the scan (ops/costas.py) at the bench's
    widths: 24 detections x 16 channels per group (384 rows) and x 64
    channels (1536), over the header pass (192 symbols) and the 1536-byte
    payload pass (6,160 symbols)."""
    import jax

    from gr4_packet_modem_tpu.ops.costas_gpu import costas_track

    out = []
    for rows, syms, offset in shapes:
        args = [jax.device_put(a) for a in costas_inputs(rows, syms)]
        kern = jax.jit(lambda s, p, f, o=offset: costas_track(
            s, p, f, offset=o, interpret=interpret))
        scan = jax.jit(lambda s, p, f, o=offset: costas_track(
            s, p, f, offset=o, use_pallas=False))
        tk, ts = timed(kern, *args, iters=iters), timed(scan, *args, iters=iters)
        (ck, pk, _), (cs, ps, _) = tk.pop("out"), ts.pop("out")
        ck, cs = np.asarray(ck), np.asarray(cs)
        flips = int(np.sum(np.sign(ck.real) != np.sign(cs.real))
                    + np.sum(np.sign(ck.imag) != np.sign(cs.imag)))
        err = float(np.max(np.abs(ck - cs)))
        perr = float(np.max(np.abs(wrap(np.asarray(pk) - np.asarray(ps)))))
        check(flips == 0, f"costas {rows}x{syms}: {flips} hard decisions differ")
        check(err <= KERNEL_ATOL and perr <= KERNEL_ATOL,
              f"costas {rows}x{syms}: error {err}/{perr} > {KERNEL_ATOL}")
        out.append({"rows": rows, "symbols": syms, "offset": offset,
                    "kernel_ms": tk["median_ms"], "scan_ms": ts["median_ms"],
                    "kernel": tk, "scan": ts, "max_abs_err": err,
                    "end_phase_err": perr, "atol": KERNEL_ATOL,
                    "hard_decision_flips": flips})
    return out


def phase_multi(stim, channels: int = CHANNELS, group: int = GROUP) -> dict:
    """StreamingShardedBank and ReceiverBank on a (2, 2) mesh against the
    single-device bank step on the same block: the same packets, byte for
    byte, each exactly once. Bursts run back to back through every channel,
    so packets straddle the time-shard boundary, and both channel shards
    carry traffic."""
    import jax
    import jax.numpy as jnp

    from bench import bank_input, channel_rotation, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver
    from gr4_packet_modem_tpu.parallel.bank import (
        BankConfig,
        ReceiverBank,
        make_mesh,
    )
    from gr4_packet_modem_tpu.parallel.serving import StreamingShardedBank

    mesh = make_mesh(4, time_shards=2)
    check(mesh.devices.shape == (2, 2), f"mesh {mesh.devices.shape}")
    cfg = rx_config(stim, "vv")
    rx = Receiver(cfg)
    # the reference: the single-device bank step on device 0
    det, _, res, _ = rx.bank_step(
        jax.device_put(bank_input(stim, channels, rx), jax.devices()[0]), group
    )
    ref = accepted_payloads(res, channels)
    check_bank(stim, channels, det, res)

    sig = np.stack(
        [stim.signal * channel_rotation(c) for c in range(channels)]
    ).astype(np.complex64)

    # resident sharded bank: halo exchange between time shards
    rbank = ReceiverBank(mesh, BankConfig(
        num_channels=channels, block_samples=stim.block // 2, rx=cfg,
        channel_group=group,
    ))
    xs = jax.device_put(sig, rbank.sharding())
    shards = xs.addressable_shards
    check(len({s.device for s in shards}) == 4
          and all(s.data.shape == (channels // 2, stim.block // 2)
                  for s in shards), "input not spread over the four devices")
    t = timed(rbank.step, xs, iters=3)
    rres = t.pop("out")
    check(len(rres.data.sharding.device_set) == 4,
          "results not spread over the four devices")
    got_r = accepted_payloads(rres, channels)

    # host-fed sharded serving over the same block, then flushed
    sbank = StreamingShardedBank(
        mesh, cfg, channels=channels, block=stim.block,
        transfer_dtype=jnp.int8, group=group,
        result_budget=stim.budget_per_ch * (channels // 2),
    )
    pkts = sbank.process(sig) + sbank.flush()
    check(sbank.overflow_blocks == 0 and sbank.budget_overflow_blocks == 0,
          "sharded serving overflowed")
    got_s = [[] for _ in range(channels)]
    for p in sorted(pkts, key=lambda p: (p.channel, p.index)):
        got_s[p.channel].append(p.data)
    for name, got in (("ReceiverBank", got_r), ("StreamingShardedBank", got_s)):
        for c in range(channels):
            check(len(got[c]) == len(ref[c])
                  and all(np.array_equal(a, b) for a, b in zip(got[c], ref[c])),
                  f"{name} channel {c}: {len(got[c])} packets vs "
                  f"{len(ref[c])} single-device")
    peak = [d.memory_stats().get("peak_bytes_in_use")
            if d.memory_stats() else None for d in mesh.devices.ravel()]
    return {"mesh": list(mesh.devices.shape), "channels": channels,
            "block": stim.block, "packets": int(sum(map(len, ref))),
            "receiver_bank": t, "peak_bytes_per_device": peak}


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path on a (2, 2) mesh of "
                         "four GPUs")
    args = ap.parse_args(argv)

    import jax

    from bench import device_info
    from gr4_packet_modem_tpu.utils.platform import setup

    setup()
    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev['platform']!r})",
              file=sys.stderr)
        return 1
    need = 4 if args.multi else 1
    if dev["count"] < need:
        print(f"chip_smoke: needs {need} GPUs, found {dev['count']}",
              file=sys.stderr)
        return 1

    from bench import make_stimulus

    # (a) the card
    cards = card_lines()
    for ln in cards:
        print(ln, flush=True)
    emit("a_device", cards=cards, device=dev,
         jax_version=jax.__version__)
    stim = make_stimulus(BLOCK)

    if args.multi:
        emit("multi", **phase_multi(stim))
        print(last_line(dev), flush=True)
        return 0

    cpu = jax.devices("cpu")[0]
    emit("b_tx", **phase_tx(stim, cpu))
    emit("c_bank", **phase_bank(stim, CHANNELS, "vv"))
    emit("d_costas", **phase_bank(stim, COSTAS_CHANNELS, "costas"))
    emit("e_gpu_vs_cpu", **phase_gpu_vs_cpu(stim, cpu))
    emit("f_serving", **phase_serving(stim))
    emit("g_kernels", costas=phase_kernels())
    print(last_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
