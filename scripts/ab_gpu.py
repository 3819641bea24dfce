#!/usr/bin/env python3
"""A/B measurements behind the receiver's GPU implementation choices.

Each section times two plain forms of one stage at the bench geometry
(bench.py: 1536-byte payload bound, 4 frequency bins, 16-channel groups of
24 detections) and checks that they agree:

  acq      fft vs conv acquisition correlator (16 channels x 2^19)
  ldpc     LDPC decode with the 25 iterations rolled vs unrolled, alone
           and inside the bench step (64 channels, vv carrier)
  costas   the Costas kernel vs the scan, end to end: the bench step
           (64 channels, vv carrier) and the costas-carrier step (16 ch)
  trace    device time by operation for one 16-channel vv bank step

One JSON object per line on stdout; the trace summary also goes to
``chiprun_out/ab_trace.json``. Runs where JAX's default device is (the GPU);
``--sections`` picks a subset.

usage: python scripts/ab_gpu.py [--sections acq,ldpc,costas,trace]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

# bench geometry; --block / --channels shrink it for a CPU rehearsal
GEOM = {"block": 1 << 19, "channels": 64}


def emit(section, **kw):
    print(json.dumps({"section": section, **kw}, default=float), flush=True)


def timed(fn, *args):
    """``(output, timing)`` of ``fn(*args)`` (chip_smoke.timed)."""
    from chip_smoke import timed as _timed

    t = _timed(fn, *args)
    return t.pop("out"), t


def section_acq():
    import jax

    from bench import bank_input, make_stimulus, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver

    stim = make_stimulus(GEOM["block"])
    res, dets = {}, {}
    for backend in ("fft", "conv"):
        rx = Receiver(rx_config(stim, "vv", backend))
        x = jax.device_put(bank_input(stim, 16, rx))
        f = jax.jit(jax.vmap(lambda xc, rx=rx: rx.acquirer.acquire(xc)))
        dets[backend], res[backend] = timed(f, x)
    vf, vc = np.asarray(dets["fft"].valid), np.asarray(dets["conv"].valid)
    same = np.array_equal(vf, vc) and all(
        np.array_equal(np.asarray(getattr(dets["fft"], n))[vf],
                       np.asarray(getattr(dets["conv"], n))[vc])
        for n in ("index", "freq_bin")
    )
    emit("acq", channels=16, block=stim.block, detections_identical=same,
         **res)


def section_ldpc():
    import jax
    import jax.numpy as jnp

    from gr4_packet_modem_tpu.ops import ldpc

    rng = np.random.default_rng(1)
    for b in (384, 1536):
        bits = rng.integers(0, 2, (b, 32), dtype=np.uint8)
        cw = np.asarray(ldpc.encode_header(jnp.asarray(bits)))[:, :128]
        sigma = 0.8
        llr = (2 / sigma**2) * (1 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))
        llr = jax.device_put(llr.astype(np.float32))
        outs, res = {}, {}
        for name, unroll in (("rolled", 1), ("unrolled", True)):
            dec = ldpc.HeaderLdpcDecoder(25, unroll=unroll)
            outs[name], res[name] = timed(dec.decode, llr)
        same = all(np.array_equal(np.asarray(a), np.asarray(c))
                   for a, c in zip(outs["rolled"], outs["unrolled"]))
        emit("ldpc", batch=b, identical=same, **res)
    from bench import bank_input, make_stimulus, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver

    stim = make_stimulus(GEOM["block"])
    res = {}
    for name, unroll in (("rolled", 1), ("unrolled", True)):
        rx = Receiver(rx_config(stim, "vv"))
        rx._decoder = ldpc.HeaderLdpcDecoder(25, unroll=unroll)
        x = jax.device_put(bank_input(stim, GEOM["channels"], rx))
        f = jax.jit(lambda xs, rx=rx: rx.bank_step(xs, 16))
        (_, _, r, _), res[name] = timed(f, x)
        res[name]["accepted"] = int(np.asarray(r.accepted).sum())
        del x
    emit("ldpc_e2e", channels=GEOM["channels"], carrier="vv", **res)


def section_costas():
    import jax

    from bench import bank_input, make_stimulus, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver

    stim = make_stimulus(GEOM["block"])
    for channels, carrier in ((GEOM["channels"], "vv"), (16, "costas")):
        res = {}
        for name, use_pallas in (("kernel", None), ("scan", False)):
            rx = Receiver(rx_config(stim, carrier, use_pallas=use_pallas))
            x = jax.device_put(bank_input(stim, channels, rx))
            f = jax.jit(lambda xs, rx=rx: rx.bank_step(xs, 16))
            (_, _, r, _), res[name] = timed(f, x)
            res[name]["accepted"] = int(np.asarray(r.accepted).sum())
            del x
        emit("costas_e2e", channels=channels, carrier=carrier,
             expected=stim.pkts_per_block * channels, **res)


def trace_summary(trace_dir: str, top: int = 25) -> dict:
    """Device time by operation name from a jax.profiler trace: the sum of
    event durations per name on the device planes, the window they span,
    and the busy share (union of event intervals over the window)."""
    from jax.profiler import ProfileData

    pb = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                   recursive=True)
    pd = ProfileData.from_file(pb[0])
    dev_lines = [
        (plane.name, line) for plane in pd.planes
        if plane.name.startswith("/device:GPU") for line in plane.lines
    ]
    # the "XLA Ops" line names each HLO op; without it, the stream lines
    # carry the kernels
    ops_lines = [pl for pl in dev_lines if pl[1].name == "XLA Ops"] or [
        pl for pl in dev_lines if pl[1].name.startswith("Stream")
    ]
    by_name, spans = {}, []
    lines = sorted(f"{p}|{line.name}" for p, line in dev_lines)
    for _, line in ops_lines:
        for ev in line.events:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.duration_ns
            spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        return {"lines": lines, "events": 0}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"lines": lines, "events": len(spans),
            "window_ms": window / 1e6, "busy_ms": busy / 1e6,
            "busy_share": busy / window,
            "top_ops_ms": [(n, t / 1e6) for n, t in ops]}


def section_trace():
    import jax

    from bench import bank_input, make_stimulus, rx_config
    from gr4_packet_modem_tpu.models.receiver import Receiver

    stim = make_stimulus(GEOM["block"])
    rx = Receiver(rx_config(stim, "vv"))
    x = jax.device_put(bank_input(stim, 16, rx))
    f = jax.jit(lambda xs: rx.bank_step(xs, 16))
    jax.block_until_ready(f(x))
    d = os.path.join(ROOT, "chiprun_out", "ab_trace")
    with jax.profiler.trace(d):
        for _ in range(3):
            jax.block_until_ready(f(x))
    summ = trace_summary(d)
    shutil.rmtree(d)  # raw traces are large; keep the summary only
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_trace.json"), "w") as fh:
        json.dump(summ, fh, indent=1)
    emit("trace", steps=3, channels=16,
         **{k: v for k, v in summ.items() if k != "top_ops_ms"},
         top_ops_ms=summ.get("top_ops_ms", [])[:12])


SECTIONS = {"acq": section_acq,
            "ldpc": section_ldpc, "costas": section_costas,
            "trace": section_trace}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--block", type=int, default=GEOM["block"])
    ap.add_argument("--channels", type=int, default=GEOM["channels"])
    args = ap.parse_args()
    GEOM.update(block=args.block, channels=args.channels)
    import jax

    from gr4_packet_modem_tpu.utils.platform import setup

    setup()
    d = jax.devices()[0]
    emit("device", platform=d.platform, kind=d.device_kind,
         count=len(jax.devices()))
    for name in args.sections.split(","):
        SECTIONS[name]()


if __name__ == "__main__":
    main()
