"""Streaming drivers: block-wise modem execution with carried state.

The reference runs its modem as a free-running dataflow graph; here the
compiled kernels are driven block-by-block by a host loop with fixed-size
device buffers (the equivalent of the scheduler + ring buffers):

- ``StreamingReceiver``: feeds fixed-size sample blocks through the receiver
  with an overlap carry so packets crossing block boundaries decode exactly
  once; the in-packet suppression state (busy_until) carries across blocks.
- ``StreamingTransmitter``: batches ingress packets into burst/stream sample
  blocks, carrying the GLFSR packet index and stream-mode FIR history.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..models.receiver import (
    Receiver,
    RxConfig,
    flatten_detections,
    packet_extent_samples,
    suppress_overlapping,
)
from ..models.transmitter import Transmitter
from ..utils import constants as C
from ..utils.cplx import to_host, to_transfer_planes
from ..utils.ragged import PacketBatch, ragged_concat

__all__ = [
    "StreamingReceiver",
    "StreamingBank",
    "StreamingTransmitter",
    "PacketToStream",
    "DecodedPacket",
    "pack_result_wire",
    "unpack_result_wire",
]


@dataclass
class DecodedPacket:
    data: np.ndarray
    index: int            # absolute sample index of the syncword start
    packet_type: int
    esn0_db: float
    channel: int = 0      # bank channel (StreamingBank)
    freq: float = 0.0     # carrier frequency estimate (rad/sample)
    arm: int = 0          # polyphase matched-filter arm (symbol timing)


def pack_result_wire(
    idx, lens, types, esn0, freq, arm, chan, accepted, data,
    det_overflow, budget: int | None,
):
    """Pack per-row decode results into ONE flat u8 array for the d2h wire
    (each d2h transfer pays a fixed latency, so the host pulls a single
    byte buffer per block).

    With ``budget`` set, rows are COMPACTED on device to the first ``budget``
    accepted rows (stable row order, so per-channel index order is kept)
    before the transfer — the reference only ever ships decoded packets
    (tun_sink.hpp:33-37), while an uncompacted wire ships
    ``rows x max_payload_len`` bytes of mostly-unused slots (the dominant
    serving d2h cost at bank widths). ``accepted``
    beyond the budget is flagged (second flag slot) rather than silently
    dropped.

    Wire layout: 9 f32 metadata rows per slot (index, length, type, esn0,
    freq, arm, channel, accepted, source-row), 2 f32 flags (detection
    overflow, budget overflow), then the payload byte matrix.
    """
    rows = idx.shape[0]
    k = rows if budget is None else min(int(budget), rows)
    row_ids = jnp.arange(rows, dtype=jnp.int32)
    n_acc = jnp.sum(accepted.astype(jnp.int32))
    budget_ovf = n_acc > k
    if k < rows:
        # stable argsort: accepted rows first, original order preserved
        order = jnp.argsort(~accepted, stable=True)
        sel = order[:k]
        take = lambda a: jnp.take(a, sel, axis=0)  # noqa: E731
        idx, lens, types, esn0, freq, arm, chan, accepted, data, row_ids = (
            take(a)
            for a in (idx, lens, types, esn0, freq, arm, chan, accepted,
                      data, row_ids)
        )
    f32 = jnp.float32
    meta = jnp.concatenate([
        idx.astype(f32), lens.astype(f32), types.astype(f32),
        esn0.astype(f32), freq.astype(f32), arm.astype(f32),
        chan.astype(f32), accepted.astype(f32), row_ids.astype(f32),
        det_overflow.astype(f32)[None], budget_ovf.astype(f32)[None],
    ])
    meta_u8 = jax.lax.bitcast_convert_type(meta, jnp.uint8).reshape(-1)
    return jnp.concatenate([meta_u8, data.reshape(-1)])


_WIRE_META_FIELDS = 9


def wire_slots(rows: int, budget: int | None) -> int:
    """Number of result slots on the wire for ``rows`` decode rows."""
    return rows if budget is None else min(int(budget), rows)


def wire_bytes(rows: int, budget: int | None, max_len: int) -> int:
    k = wire_slots(rows, budget)
    return 4 * (_WIRE_META_FIELDS * k + 2) + k * max_len


def unpack_result_wire(packed: np.ndarray, k: int, max_len: int):
    """Host-side inverse of :func:`pack_result_wire`.

    Returns ``(slots, det_overflow, budget_overflow)`` where ``slots`` is a
    dict of per-slot arrays (``index/length/type/esn0/freq/arm/channel/
    accepted/row/data``)."""
    meta_bytes = 4 * (_WIRE_META_FIELDS * k + 2)
    meta = packed[:meta_bytes].view(np.float32)
    data = packed[meta_bytes:].reshape(k, max_len)
    f = lambda i: meta[i * k : (i + 1) * k]  # noqa: E731
    slots = {
        "index": f(0).astype(np.int64),
        "length": f(1).astype(np.int64),
        "type": f(2).astype(np.int64),
        "esn0": f(3),
        "freq": f(4),
        "arm": f(5).astype(np.int64),
        "channel": f(6).astype(np.int64),
        "accepted": f(7) > 0.5,
        "row": f(8).astype(np.int64),
        "data": data,
    }
    flags = meta[_WIRE_META_FIELDS * k :]
    return slots, flags[0] > 0.5, flags[1] > 0.5


def _flag_overflows(driver, det_ovf: bool, budget_ovf: bool) -> None:
    """Count + warn-once for the two per-block saturation flags."""
    import warnings

    if det_ovf:
        driver.overflow_blocks += 1
        if driver.overflow_blocks == 1:
            warnings.warn(
                "acquisition candidate cap saturated (max_detections = "
                f"{driver.rx.config.max_detections}); packets may be "
                "dropped — raise RxConfig.max_detections",
                RuntimeWarning,
                stacklevel=4,
            )
    if budget_ovf:
        driver.budget_overflow_blocks += 1
        if driver.budget_overflow_blocks == 1:
            warnings.warn(
                "result-wire budget saturated (result_budget = "
                f"{driver.result_budget}); packets were dropped from the "
                "d2h wire — raise result_budget",
                RuntimeWarning,
                stacklevel=4,
            )


def _start_d2h(driver, packed) -> None:
    """Kick off the result wire's d2h as soon as the step is dispatched so
    the transfer overlaps the next blocks' compute instead of serializing
    into materialize (best-effort; not all backends support async copy).
    ``PM_ASYNC_D2H=0`` disables (A/B hook: on some backends the async copy
    of a sharded array blocks the dispatching thread instead)."""
    import os

    if os.environ.get("PM_ASYNC_D2H") == "0":
        return
    if getattr(driver, "_async_d2h", True):
        try:
            packed.copy_to_host_async()
        except Exception:
            driver._async_d2h = False


_rx_logger = None


def _log_packet(p: DecodedPacket) -> None:
    """Per-packet RX debug line (PayloadMetadataInsert{log:true} /
    header_debug, payload_metadata_insert.hpp:66,
    packet_receiver.hpp:151-157)."""
    global _rx_logger
    if _rx_logger is None:
        import logging

        _rx_logger = logging.getLogger("gr4_packet_modem_tpu.rx")
    _rx_logger.info(
        "packet ch=%d index=%d len=%d type=%d esn0=%.1fdB freq=%+.5f arm=%d",
        p.channel, p.index, len(p.data), p.packet_type, p.esn0_db, p.freq,
        p.arm,
    )


class StreamingReceiver:
    """Block-streaming wrapper around the batched Receiver.

    ``header_tap`` / ``payload_tap`` are optional sinks with a
    ``send(np.ndarray)`` method (e.g. io.zmq_pub.ZmqPduPubSink); when given,
    the post-Costas header / payload symbols of every accepted packet are
    published per packet — the ZMQ monitoring taps of
    packet_receiver.hpp:159-189 feeding scripts/plot_symbols.py."""

    def __init__(
        self,
        config: RxConfig = RxConfig(),
        block: int = 1 << 18,
        header_tap=None,
        payload_tap=None,
        transfer_dtype=None,
        pipeline_depth: int = 2,
        result_budget: int | None = None,
        log: bool = False,
    ):
        import dataclasses

        # optional reduced-precision h2d (see utils.cplx.to_device): halves
        # (bf16) or quarters (int8) the wire size on h2d-bound links
        self.transfer_dtype = transfer_dtype
        # d2h compaction: ship only `result_budget` accepted-first result
        # rows per block instead of all max_detections slots (see
        # pack_result_wire); overflow beyond the budget is flagged
        self.result_budget = result_budget
        # per-packet RX debug log, mirroring the reference's
        # PayloadMetadataInsert{log:true} + header_debug tap
        # (payload_metadata_insert.hpp:66, packet_receiver.hpp:151-157)
        self.log = log
        # blocks in flight before results are materialized: depth >= 2 hides
        # the d2h materialization latency of block N behind the h2d + compute
        # of blocks N+1..N+depth (the reference overlaps the same way via
        # free-running ring buffers between scheduler threads)
        self.pipeline_depth = max(1, int(pipeline_depth))

        self.header_tap = header_tap
        self.payload_tap = payload_tap
        if payload_tap is not None and not config.keep_payload_symbols:
            config = dataclasses.replace(config, keep_payload_symbols=True)
        self.rx = Receiver(config)
        self.block = block
        fp, pt = self.rx.front_pad, self.rx.pad_tail()
        self.fp, self.pt = fp, pt
        self.buf_len = fp + block + pt
        # per-block metadata travels as ONE f32 array (one d2h transfer
        # instead of one per field); f32 is exact for integers < 2^24, which
        # bounds the buffer-local indices it carries
        if self.buf_len >= 1 << 24:
            raise ValueError(
                "block too large: buffer-local indices must stay below 2^24 "
                "for the packed f32 metadata transfer"
            )
        # plane-split zeros, built from real planes
        self._buf = jax.lax.complex(
            jnp.zeros(self.buf_len, jnp.float32),
            jnp.zeros(self.buf_len, jnp.float32),
        )
        # absolute stream index of buf[0]; the first real sample lands at
        # buffer position fp + pt after the first block append
        self._abs_offset = -(fp + pt + block)
        # in-packet suppression state, device-resident (local coordinates of
        # the *next* block) so consecutive steps chain without a host sync
        self._busy_dev = jnp.int32(-(1 << 30))
        self._pending = np.zeros(0, np.complex64)
        self.overflow_blocks = 0  # blocks whose acquisition saturated
        self.budget_overflow_blocks = 0  # blocks whose result wire saturated
        # pipelined execution: results of block N are materialized on the
        # host while blocks N+1..N+depth compute (SURVEY §7 hard-part 5)
        self._inflight: list = []
        # per-stage host wall times (seconds, cumulative) for separating the
        # h2d wire ceiling from driver/step overhead
        self.stats = {"h2d_s": 0.0, "dispatch_s": 0.0, "materialize_s": 0.0,
                      "blocks": 0}
        # symbol outputs cost extra d2h; only produced when a tap wants them
        self._with_syms = header_tap is not None or payload_tap is not None
        # the sliding buffer is donated to the step (updated in place on
        # device); dequantization of the wire planes, the buffer shift and
        # the output packing all live INSIDE the jit, so each block is one
        # dispatch
        self._step = jax.jit(self._make_step(), donate_argnums=0)

    def _make_step(self):
        rx = self.rx
        from ..utils.cplx import planes_to_complex

        # numpy scalars, not eager jnp scalars: they embed as literals, so
        # the jitted closure captures no device buffer
        fresh_lo = np.int32(self.fp)
        fresh_hi = np.int32(self.fp + self.block)

        def step(buf, chunk_planes, busy0):
            # dequantize the wire planes and slide the buffer INSIDE the jit
            # (buf is donated: updated in place on device)
            chunk = planes_to_complex(
                chunk_planes, packed_int4=self.transfer_dtype == "int4"
            )
            buf = jnp.concatenate([buf[self.block :], chunk])
            # fresh-window restriction BEFORE candidate top-k: only syncword
            # starts inside [fresh_lo, fresh_hi) compete for detection slots,
            # so max_detections is sized by packets per *block* (not per
            # overlap-extended buffer) and stale/lookahead peaks cannot
            # saturate the cap
            det = rx.acquirer.acquire(
                buf, fresh_lo=fresh_lo, fresh_hi=fresh_hi
            )
            hdr, hdr_corrected = rx.decode_headers(buf, det)
            # header symbols as I/Q planes (real d2h transfers); tiny:
            # [D, 192, 2] float32
            hdr_syms = jnp.stack(
                [hdr_corrected.real, hdr_corrected.imag], axis=-1
            )
            # in-packet suppression carried across blocks via busy0 (shared
            # extent+scan helpers — models/receiver.py)
            extent = packet_extent_samples(
                hdr.packet_length, hdr.header_ok, rx.config.samples_per_symbol
            )
            busy_end, keep = suppress_overlapping(
                det.index, det.valid, extent, busy0 + det.index[0] * 0
            )
            res = rx.decode_payloads(buf, det, hdr, keep)
            # busy state pre-shifted into the next block's local coordinates
            block = jnp.int32(self.block)
            busy_next = jnp.maximum(busy_end - block, -(1 << 30))
            packed = pack_result_wire(
                det.index, res.lengths, hdr.packet_type, det.esn0_db,
                det.freq, hdr.arm, jnp.zeros_like(det.index), res.accepted,
                res.data, det.overflow, self.result_budget,
            )
            if self._with_syms:
                return buf, packed, busy_next, hdr_syms, res.symbols
            return buf, packed, busy_next

        return step

    def process(self, samples: np.ndarray) -> list[DecodedPacket]:
        """Feed samples; returns packets decoded from newly-complete blocks."""
        import time

        self._pending = np.concatenate(
            [self._pending, np.asarray(samples, np.complex64)]
        )
        out: list[DecodedPacket] = []
        while self._pending.size >= self.block:
            chunk, self._pending = (
                self._pending[: self.block],
                self._pending[self.block :],
            )
            t0 = time.perf_counter()
            # ONE contiguous [2, block] wire array (single h2d transfer);
            # dequantization happens inside the jitted step
            planes = jnp.asarray(
                to_transfer_planes(chunk, self.transfer_dtype)
            )
            self.stats["h2d_s"] += time.perf_counter() - t0
            out.extend(self._process_block(planes))
        return out

    def flush(self) -> list[DecodedPacket]:
        """Drain the pipeline: pad the buffered tail to a full block, then
        feed enough zero blocks that every real sample passes through the
        fresh decode window with full lookahead. (The fresh region always
        lags the newest ``pad_tail`` samples by design, so even when input
        ends exactly on a block boundary one more block must be pushed —
        packet_to_stream.hpp drains the same way via stream backpressure.)
        Finally the last in-flight step is materialized."""
        out: list[DecodedPacket] = []
        if self._pending.size:
            pad = np.zeros(self.block - self._pending.size, np.complex64)
            out.extend(self.process(pad))
        nz = -(-self.pt // self.block)  # ceil(pt / block)
        out.extend(self.process(np.zeros(nz * self.block, np.complex64)))
        out.extend(self._drain())
        return out

    def _process_block(self, planes: jax.Array) -> list[DecodedPacket]:
        import time

        t0 = time.perf_counter()
        self._abs_offset += self.block
        # dispatch asynchronously (buffer slide + dequant inside the jit);
        # completed blocks' results are materialized below while this step
        # runs on device
        outs = self._step(self._buf, planes, self._busy_dev)
        self._buf = outs[0]
        self._busy_dev = outs[2]
        self._inflight.append((outs, self._abs_offset))
        _start_d2h(self, outs[1])
        self.stats["dispatch_s"] += time.perf_counter() - t0
        self.stats["blocks"] += 1
        out: list[DecodedPacket] = []
        while len(self._inflight) > self.pipeline_depth:
            t0 = time.perf_counter()
            out.extend(self._materialize(self._inflight.pop(0)))
            self.stats["materialize_s"] += time.perf_counter() - t0
        return out

    def _drain(self) -> list[DecodedPacket]:
        import time

        out: list[DecodedPacket] = []
        while self._inflight:
            t0 = time.perf_counter()
            out.extend(self._materialize(self._inflight.pop(0)))
            self.stats["materialize_s"] += time.perf_counter() - t0
        return out

    def _materialize(self, inflight) -> list[DecodedPacket]:
        outs, abs_offset = inflight
        k = wire_slots(self.rx.config.max_detections, self.result_budget)
        packed = np.asarray(outs[1])  # ONE d2h for metadata AND payloads
        slots, det_ovf, budget_ovf = unpack_result_wire(
            packed, k, self.rx.config.max_payload_len
        )
        _flag_overflows(self, det_ovf, budget_ovf)
        accepted = slots["accepted"]
        out = []
        if accepted.any():
            if self.header_tap is not None:
                hs = np.asarray(outs[3])  # [D, 192, 2]
            if self.payload_tap is not None:
                ps = np.asarray(outs[4])  # [D, S, 2]
            for i in np.nonzero(accepted)[0]:
                n = int(slots["length"][i])
                out.append(
                    DecodedPacket(
                        data=slots["data"][i, :n].copy(),
                        index=int(slots["index"][i]) + abs_offset,
                        packet_type=int(slots["type"][i]),
                        esn0_db=float(slots["esn0"][i]),
                        freq=float(slots["freq"][i]),
                        arm=int(slots["arm"][i]),
                    )
                )
                if self.log:
                    _log_packet(out[-1])
                r = int(slots["row"][i])  # pre-compaction decode row
                if self.header_tap is not None:
                    # the 128 header symbols after the syncword, as in the
                    # reference's post-SyncwordRemove header tap (port 5000)
                    h = hs[r, C.SYNCWORD_LEN :]
                    self.header_tap.send(
                        (h[:, 0] + 1j * h[:, 1]).astype(np.complex64)
                    )
                if self.payload_tap is not None:
                    n_syms = 4 * (n + C.CRC_NUM_BYTES)
                    p = ps[r, :n_syms]
                    self.payload_tap.send(
                        (p[:, 0] + 1j * p[:, 1]).astype(np.complex64)
                    )
        return out


class StreamingBank:
    """Host-fed multi-channel streaming receiver: the sustained serving path
    for a whole channel bank on one chip.

    The reference's serving story is its free-running real-time apps
    (apps/packet_transceiver.cpp:99-131, tun_source.hpp:69-78) — one
    channel per process. Here C channels stream through ONE compiled step
    per block: a single ``[2, C, block]`` wire array per block (one h2d
    transfer, optionally int8 fixed-point), per-channel sliding buffers and
    in-packet suppression state carried on device, the decode passes
    lane-packed across all channels' detections (Receiver.decode_bank
    layout), and ONE packed byte array back per block. Channel-group
    pipelining (``group``) bounds the working set exactly as in
    ``Receiver.bank_step``. Results materialize ``pipeline_depth`` blocks
    behind the feed so d2h overlaps compute.
    """

    def __init__(
        self,
        config: RxConfig = RxConfig(),
        channels: int = 8,
        block: int = 1 << 18,
        transfer_dtype=None,
        pipeline_depth: int = 2,
        group: int = 16,
        result_budget: int | None = None,
        log: bool = False,
    ):
        self.transfer_dtype = transfer_dtype
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.result_budget = result_budget
        self.log = log
        self.rx = Receiver(config)
        self.channels = int(channels)
        self.block = block
        self.group = (
            group if 0 < group < channels and channels % group == 0 else 0
        )
        fp, pt = self.rx.front_pad, self.rx.pad_tail()
        self.fp, self.pt = fp, pt
        self.buf_len = fp + block + pt
        if self.buf_len >= 1 << 24:
            raise ValueError(
                "block too large: buffer-local indices must stay below 2^24 "
                "for the packed f32 metadata transfer"
            )
        c = self.channels
        self._buf = jax.lax.complex(
            jnp.zeros((c, self.buf_len), jnp.float32),
            jnp.zeros((c, self.buf_len), jnp.float32),
        )
        self._abs_offset = -(fp + pt + block)
        self._busy_dev = jnp.full((c,), -(1 << 30), jnp.int32)
        self._pending = np.zeros((c, 0), np.complex64)
        self.overflow_blocks = 0
        self.budget_overflow_blocks = 0
        self._inflight: list = []
        self.stats = {"h2d_s": 0.0, "dispatch_s": 0.0, "materialize_s": 0.0,
                      "blocks": 0}
        self._step = jax.jit(self._make_step(), donate_argnums=0)

    def _make_step(self):
        rx = self.rx
        from ..utils.cplx import planes_to_complex

        # numpy scalars, not eager jnp scalars: they embed as literals, so
        # the jitted closure captures no device buffer
        fresh_lo = np.int32(self.fp)
        fresh_hi = np.int32(self.fp + self.block)
        dd = rx.config.max_detections
        sps = rx.config.samples_per_symbol

        def decode_group(args):
            g_buf, g_busy = args  # [G, buf_len] complex, [G] int32
            det = jax.vmap(
                lambda xc: rx.acquirer.acquire(
                    xc, fresh_lo=fresh_lo, fresh_hi=fresh_hi
                )
            )(g_buf)
            detf, chan = flatten_detections(det)
            hdr, _ = rx.decode_headers(g_buf, detf, chan)
            extent = packet_extent_samples(
                hdr.packet_length, hdr.header_ok, sps
            )
            g = g_buf.shape[0]
            busy_end, keep = jax.vmap(suppress_overlapping)(
                det.index, det.valid, extent.reshape(g, dd), g_busy
            )
            keep = keep.reshape(-1)
            res = rx.decode_payloads(g_buf, detf, hdr, keep, chan)
            return (
                detf.index, res.lengths, hdr.packet_type, detf.esn0_db,
                detf.freq, hdr.arm, res.accepted, res.data,
                jnp.any(det.overflow), busy_end,
            )

        def step(buf, chunk_planes, busy0):
            chunk = planes_to_complex(
                chunk_planes, packed_int4=self.transfer_dtype == "int4"
            )  # [C, block]
            buf = jnp.concatenate([buf[:, self.block :], chunk], axis=1)
            c = self.channels
            if self.group:
                ng = c // self.group
                outs = jax.lax.map(
                    decode_group,
                    (
                        buf.reshape(ng, self.group, self.buf_len),
                        busy0.reshape(ng, self.group),
                    ),
                )
                (idx, lens, types, esn0, freq, arm, acc, data, ovf,
                 busy_end) = outs
                flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
                idx, lens, types, esn0, freq, arm, acc, data, busy_end = (
                    flat(o) for o in (idx, lens, types, esn0, freq, arm,
                                      acc, data, busy_end)
                )
                overflow = jnp.any(ovf)
            else:
                (idx, lens, types, esn0, freq, arm, acc, data, overflow,
                 busy_end) = decode_group((buf, busy0))
            busy_next = jnp.maximum(
                busy_end.reshape(-1) - jnp.int32(self.block), -(1 << 30)
            )
            chan_row = jnp.arange(idx.shape[0], dtype=jnp.int32) // jnp.int32(
                dd
            )
            packed = pack_result_wire(
                idx, lens, types, esn0, freq, arm, chan_row, acc, data,
                overflow, self.result_budget,
            )
            return buf, packed, busy_next

        return step

    def process(self, samples: np.ndarray) -> list[DecodedPacket]:
        """Feed ``[C, n]`` samples (all channels advance in lockstep);
        returns packets decoded from newly-complete blocks."""
        import time

        samples = np.asarray(samples, np.complex64)
        if samples.shape[0] != self.channels:
            raise ValueError(
                f"expected [{self.channels}, n] samples, got {samples.shape}"
            )
        self._pending = np.concatenate([self._pending, samples], axis=1)
        out: list[DecodedPacket] = []
        while self._pending.shape[1] >= self.block:
            chunk = self._pending[:, : self.block]
            self._pending = self._pending[:, self.block :]
            t0 = time.perf_counter()
            planes = self._to_device_planes(
                to_transfer_planes(chunk, self.transfer_dtype)
            )
            self.stats["h2d_s"] += time.perf_counter() - t0
            out.extend(self._process_block(planes))
        return out

    def _to_device_planes(self, planes_np: np.ndarray) -> jax.Array:
        """Upload one block's wire planes (overridden by the sharded driver
        to device_put with a (ch, time) sharding)."""
        return jnp.asarray(planes_np)

    def flush(self) -> list[DecodedPacket]:
        """Drain: pad the tail to a block, push the lookahead through the
        fresh window, materialize the pipeline (see StreamingReceiver.flush)."""
        out: list[DecodedPacket] = []
        if self._pending.shape[1]:
            pad = np.zeros(
                (self.channels, self.block - self._pending.shape[1]),
                np.complex64,
            )
            out.extend(self.process(pad))
        nz = -(-self.pt // self.block)
        out.extend(
            self.process(
                np.zeros((self.channels, nz * self.block), np.complex64)
            )
        )
        out.extend(self._drain())
        return out

    def _process_block(self, planes: jax.Array) -> list[DecodedPacket]:
        import time

        t0 = time.perf_counter()
        self._abs_offset += self.block
        outs = self._step(self._buf, planes, self._busy_dev)
        self._buf = outs[0]
        self._busy_dev = outs[2]
        self._inflight.append((outs, self._abs_offset))
        _start_d2h(self, outs[1])
        self.stats["dispatch_s"] += time.perf_counter() - t0
        self.stats["blocks"] += 1
        out: list[DecodedPacket] = []
        while len(self._inflight) > self.pipeline_depth:
            t0 = time.perf_counter()
            out.extend(self._materialize(self._inflight.pop(0)))
            self.stats["materialize_s"] += time.perf_counter() - t0
        return out

    def _drain(self) -> list[DecodedPacket]:
        import time

        out: list[DecodedPacket] = []
        while self._inflight:
            t0 = time.perf_counter()
            out.extend(self._materialize(self._inflight.pop(0)))
            self.stats["materialize_s"] += time.perf_counter() - t0
        return out

    def _materialize(self, inflight) -> list[DecodedPacket]:
        outs, abs_offset = inflight
        rows = self.channels * self.rx.config.max_detections
        k = wire_slots(rows, self.result_budget)
        packed = np.asarray(outs[1])
        slots, det_ovf, budget_ovf = unpack_result_wire(
            packed, k, self.rx.config.max_payload_len
        )
        _flag_overflows(self, det_ovf, budget_ovf)
        out = []
        for i in np.nonzero(slots["accepted"])[0]:
            n = int(slots["length"][i])
            out.append(
                DecodedPacket(
                    data=slots["data"][i, :n].copy(),
                    index=int(slots["index"][i]) + abs_offset,
                    packet_type=int(slots["type"][i]),
                    esn0_db=float(slots["esn0"][i]),
                    channel=int(slots["channel"][i]),
                    freq=float(slots["freq"][i]),
                    arm=int(slots["arm"][i]),
                )
            )
            if self.log:
                _log_packet(out[-1])
        return out


class PacketToStream:
    """Burst -> continuous-stream converter with starve-time zero fill
    (packet_to_stream.hpp:17-45): ``pull(n)`` always returns exactly ``n``
    samples for a constant-rate DAC. Queued bursts are emitted back-to-back;
    when the queue runs dry *between* packets the output is zero-filled, but
    zeros are never inserted mid-packet — a partially-emitted burst is
    always finished from its own samples first. ``on_packet`` mirrors the
    optional ``count`` port (one call per burst that starts crossing, with
    the running total) for the latency credit loop (PacketCounter)."""

    def __init__(self, on_packet=None):
        self._queue: list[np.ndarray] = []
        self._current: np.ndarray | None = None
        self._pos = 0
        self._packet_count = 0
        self.on_packet = on_packet
        self.zeros_inserted = 0

    def push(self, burst: np.ndarray) -> None:
        """Enqueue one finished burst (one packet's samples)."""
        b = np.asarray(burst, np.complex64)
        if b.size:
            self._queue.append(b)

    @property
    def pending(self) -> int:
        """Samples queued (including the unfinished current packet)."""
        n = sum(b.size for b in self._queue)
        if self._current is not None:
            n += self._current.size - self._pos
        return n

    def pull(self, n: int) -> np.ndarray:
        """Return exactly ``n`` samples: packet data while available,
        zeros between packets when starved."""
        out = np.zeros(n, np.complex64)
        filled = 0
        while filled < n:
            if self._current is None:
                if not self._queue:
                    # starved between packets: zero-fill the rest
                    self.zeros_inserted += n - filled
                    break
                self._current = self._queue.pop(0)
                self._pos = 0
                self._packet_count += 1
                if self.on_packet is not None:
                    self.on_packet(self._packet_count)
            take = min(n - filled, self._current.size - self._pos)
            out[filled : filled + take] = self._current[
                self._pos : self._pos + take
            ]
            self._pos += take
            filled += take
            if self._pos == self._current.size:
                self._current = None
        return out


class StreamingTransmitter:
    """Host driver around the batched Transmitter with carried TX state."""

    def __init__(self, tx: Transmitter):
        self.tx = tx
        self._packet_index = 0
        self._fir_carry = None

    def send_burst(self, payloads, types=None) -> np.ndarray:
        """Modulate a list of payloads as back-to-back bursts."""
        batch = PacketBatch.from_list(
            payloads, max_len=self.tx.config.max_payload_len, types=types
        )
        samples, lens = self.tx.modulate_bursts(
            batch, packet_index0=self._packet_index
        )
        self._packet_index += len(payloads)
        n = int(np.sum(np.asarray(lens)))
        stream, total = jax.jit(
            lambda ss, ll: ragged_concat(ss, ll, n)
        )(samples, lens)
        return to_host(stream)[: int(total)]

    def send_stream(self, payloads, types=None) -> np.ndarray:
        """Modulate payloads in stream mode (continuous FIR state)."""
        batch = PacketBatch.from_list(
            payloads, max_len=self.tx.config.max_payload_len, types=types
        )
        out_syms = sum(C.stream_symbols(len(p)) for p in payloads)
        carry, samples, total = self.tx.modulate_stream(
            batch, out_syms, self._fir_carry
        )
        self._fir_carry = carry
        return to_host(samples)[: int(total)]

    def flush_stream(self) -> np.ndarray:
        """Flush the stream-mode FIR history with zero symbols and return
        the tail samples. A finite stream needs this: the interpolator's
        carry holds the last ``arm_len - 1`` symbols' contribution, so
        without a flush the final packet's last samples never leave the
        filter and the tail packet fails its matched filter / CRC. (The
        reference's burst chain appends explicit zero flush symbols for the
        same reason, packet_transmitter_pdu.hpp:251-259; its stream mode
        never terminates.) Resets the carry for a fresh stream."""
        import jax.numpy as jnp

        from ..ops.fir import stream_interpolating_fir

        if self._fir_carry is None:
            return np.zeros(0, np.complex64)
        sps = self.tx.config.samples_per_symbol
        arm_len = -(-self.tx.taps.size // sps)
        zeros = jnp.zeros(arm_len - 1, jnp.complex64)
        _, samples = stream_interpolating_fir(
            self._fir_carry, zeros, self.tx.taps, sps
        )
        self._fir_carry = None
        return to_host(samples)
