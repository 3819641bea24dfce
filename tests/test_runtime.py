"""Runtime layer tests: streaming drivers, flow control, host IO."""

import ctypes
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from gr4_packet_modem_tpu.io.file import read_c64, stream_c64_blocks, write_c64
from gr4_packet_modem_tpu.io.tun import native_lib
from gr4_packet_modem_tpu.models.channel import awgn, rotate
from gr4_packet_modem_tpu.models.receiver import RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.runtime.flow import PacketCredit, ProbeRate, Throttle
from gr4_packet_modem_tpu.runtime.streaming import (
    StreamingReceiver,
    StreamingTransmitter,
)


class TestStreaming:
    def test_block_boundaries_and_indices(self):
        tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=256)))
        payloads = [
            (np.arange(n) % 256).astype(np.uint8)
            for n in [10, 100, 200, 37, 256, 131]
        ]
        sig = tx.send_burst(payloads)
        x = np.asarray(
            awgn(jax.random.PRNGKey(0), rotate(jnp.asarray(sig), 0.006), 0.05)
        )
        rx = StreamingReceiver(
            RxConfig(max_payload_len=256, max_detections=8), block=4096
        )
        got = []
        for i in range(0, x.size, 3000):  # odd chunks exercise the carry
            got.extend(rx.process(x[i : i + 3000]))
        got.extend(rx.flush())
        assert len(got) == len(payloads)
        for g, p in zip(got, payloads):
            np.testing.assert_array_equal(g.data, p)
        assert got[0].index == 0  # absolute stream indexing
        assert all(b.index > a.index for a, b in zip(got, got[1:]))

    def test_stream_mode_carry(self):
        tx = StreamingTransmitter(
            Transmitter(TxConfig(max_payload_len=128, stream_mode=True))
        )
        payloads = [(np.arange(n) % 256).astype(np.uint8) for n in [50, 80, 20]]
        sig1 = tx.send_stream(payloads[:2])
        sig2 = tx.send_stream(payloads[2:])
        # a finite stream must flush the FIR history or the LAST packet's
        # tail samples never leave the filter (regression: the file apps
        # lost the final stream-mode packet before flush_stream existed)
        flush = tx.flush_stream()
        assert flush.size > 0
        x = np.concatenate([sig1, sig2, flush])
        rx = StreamingReceiver(
            RxConfig(max_payload_len=128, max_detections=8), block=4096
        )
        got = rx.process(x)
        got += rx.flush()
        datas = [g.data for g in got]
        assert len(datas) == len(payloads)
        for g, p in zip(datas, payloads):
            np.testing.assert_array_equal(g, p)

    def test_flush_on_block_boundary(self):
        """Regression: input ending exactly on a block boundary must not
        lose the tail packets still inside the lookahead pipeline
        (runtime/streaming.py flush)."""
        tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=256)))
        payloads = [
            (np.arange(n) % 256).astype(np.uint8) for n in [64, 128, 200]
        ]
        sig = tx.send_burst(payloads)
        rx = StreamingReceiver(
            RxConfig(max_payload_len=256, max_detections=8), block=4096
        )
        # pad the signal to an exact multiple of the block size, with the
        # last packet ending close to the final boundary
        n_blocks = -(-sig.size // rx.block)
        x = np.zeros(n_blocks * rx.block, np.complex64)
        x[x.size - sig.size :] = sig  # last packet ends at the boundary
        got = rx.process(x)
        assert rx._pending.size == 0  # truly block-aligned input
        got += rx.flush()
        assert len(got) == len(payloads)
        for g, p in zip(got, payloads):
            np.testing.assert_array_equal(g.data, p)

    def test_detection_overflow_flagged(self):
        """Regression: more packets per block than max_detections must
        raise the acquisition overflow flag instead of silently dropping
        (ops/acquire.py overflow)."""
        import warnings

        tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=16)))
        payloads = [
            ((np.arange(8) + i) % 256).astype(np.uint8) for i in range(12)
        ]
        sig = tx.send_burst(payloads)  # 12 short bursts back to back
        rx = StreamingReceiver(
            RxConfig(max_payload_len=16, max_detections=4), block=1 << 15
        )
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rx.process(sig)
            rx.flush()
        assert rx.overflow_blocks > 0
        assert any("max_detections" in str(x.message) for x in w)
        # and a sufficient cap decodes everything with no overflow
        rx2 = StreamingReceiver(
            RxConfig(max_payload_len=16, max_detections=16), block=1 << 15
        )
        got = rx2.process(sig)
        got += rx2.flush()
        assert rx2.overflow_blocks == 0
        assert len(got) == len(payloads)

    def test_fresh_window_protects_detection_cap(self):
        """Acquisition candidates are restricted to the fresh block BEFORE
        top-k: the streaming buffer holds
        front_pad + block + pad_tail samples (~several blocks of packets at
        this size), but only the fresh block's packets may compete for
        max_detections slots — a cap sized for one block must decode a
        continuous stream with zero overflow."""
        import warnings

        tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=64)))
        rng = np.random.default_rng(3)
        payloads = [
            rng.integers(0, 256, 64, dtype=np.uint8) for _ in range(14)
        ]
        sig = tx.send_burst(payloads)  # ~14 x 1.4k samples back-to-back
        rx = StreamingReceiver(
            # block 4096 holds <= 3 packet starts; the full buffer holds ~5x
            # that — a cap of 4 only works if stale/lookahead peaks are
            # excluded from candidate selection
            RxConfig(max_payload_len=64, max_detections=4),
            block=4096,
        )
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)  # no overflow warn
            got = rx.process(sig)
            got += rx.flush()
        assert rx.overflow_blocks == 0
        assert len(got) == len(payloads)
        for g, p in zip(got, payloads):
            np.testing.assert_array_equal(g.data, p)

    def test_result_budget_compaction_parity(self):
        """A compacted result wire (budget >= accepted packets) must yield
        the exact packet set of the uncompacted wire, including the
        per-packet freq/arm/esn0 metadata; a budget SMALLER than the block's
        accepted count drops the excess and flags budget_overflow_blocks."""
        tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=128)))
        payloads = [
            (np.arange(n) % 256).astype(np.uint8) for n in [60, 90, 128, 33]
        ]
        sig = tx.send_burst(payloads)
        x = np.asarray(
            awgn(jax.random.PRNGKey(3), rotate(jnp.asarray(sig), 0.004), 0.03)
        )
        cfg = RxConfig(max_payload_len=128, max_detections=8)
        results = {}
        for budget in (None, 6):
            rx = StreamingReceiver(cfg, block=4096, result_budget=budget)
            pkts = rx.process(x) + rx.flush()
            assert rx.budget_overflow_blocks == 0
            results[budget] = sorted(
                (p.index, p.data.tobytes(), round(p.esn0_db, 3),
                 round(p.freq, 6), p.arm)
                for p in pkts
            )
        assert len(results[None]) == len(payloads)
        assert results[None] == results[6]

        # budget of 1: each block ships at most one packet; with 4 packets
        # in ~2 blocks some are dropped from the wire and flagged
        import warnings as _w

        rx = StreamingReceiver(cfg, block=4096, result_budget=1)
        with _w.catch_warnings():
            _w.simplefilter("ignore", RuntimeWarning)
            pkts = rx.process(x) + rx.flush()
        assert rx.budget_overflow_blocks >= 1
        assert 0 < len(pkts) < len(payloads)

    def test_per_packet_log(self, caplog):
        """log=True emits one line per accepted packet with the reference's
        debug fields (payload_metadata_insert.hpp:66)."""
        import logging

        tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=128)))
        sig = tx.send_burst([(np.arange(70) % 256).astype(np.uint8)])
        rx = StreamingReceiver(
            RxConfig(max_payload_len=128, max_detections=4),
            block=4096,
            log=True,
        )
        with caplog.at_level(logging.INFO, logger="gr4_packet_modem_tpu.rx"):
            pkts = rx.process(np.asarray(sig)) + rx.flush()
        assert len(pkts) == 1
        lines = [r.message for r in caplog.records]
        assert len(lines) == 1
        assert "len=70" in lines[0] and "esn0=" in lines[0] \
            and "arm=" in lines[0]

    def test_int8_transfer_parity(self):
        """int8 fixed-point transfer planes (utils/cplx.py INT8_SCALE) must
        decode byte-exact at the operating Es/N0 — the wire format used by
        the h2d-bound sustained serving bench."""
        tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=256)))
        payloads = [
            (np.arange(n) % 256).astype(np.uint8) for n in [64, 200, 256]
        ]
        sig = tx.send_burst(payloads)
        x = np.asarray(
            awgn(jax.random.PRNGKey(1), rotate(jnp.asarray(sig), 0.005), 0.05)
        )
        rx = StreamingReceiver(
            RxConfig(max_payload_len=256, max_detections=8),
            block=4096,
            transfer_dtype=jnp.int8,
        )
        got = rx.process(x)
        got += rx.flush()
        assert len(got) == len(payloads)
        for g, p in zip(got, payloads):
            np.testing.assert_array_equal(g.data, p)
        assert rx.stats["blocks"] > 0 and rx.stats["h2d_s"] > 0


class TestPacketToStream:
    def test_zero_fill_between_packets_only(self):
        """Starve-time zero fill semantics (packet_to_stream.hpp:17-45):
        exact-rate pulls, zeros only between packets, never mid-packet."""
        from gr4_packet_modem_tpu.runtime.streaming import PacketToStream

        counts = []
        p2s = PacketToStream(on_packet=counts.append)
        b1 = (np.arange(1, 11) + 1j).astype(np.complex64)
        b2 = (np.arange(11, 18) + 2j).astype(np.complex64)
        p2s.push(b1)
        out1 = p2s.pull(6)  # mid-packet: first 6 of b1
        np.testing.assert_array_equal(out1, b1[:6])
        out2 = p2s.pull(8)  # finishes b1 (4), then starves -> 4 zeros
        np.testing.assert_array_equal(out2[:4], b1[6:])
        np.testing.assert_array_equal(out2[4:], 0)
        assert p2s.zeros_inserted == 4
        p2s.push(b2)
        out3 = p2s.pull(10)  # b2 (7) then 3 zeros
        np.testing.assert_array_equal(out3[:7], b2)
        np.testing.assert_array_equal(out3[7:], 0)
        assert counts == [1, 2]  # count port fired once per packet
        assert p2s.pending == 0


class TestFlow:
    def test_throttle(self):
        th = Throttle(100000.0)
        t0 = time.monotonic()
        for _ in range(5):
            th.wait(2000)
        dt = time.monotonic() - t0
        assert dt >= 0.08

    def test_probe_rate(self):
        pr = ProbeRate()
        pr.update(100)
        time.sleep(0.25)
        rep = pr.update(100)
        assert rep is not None
        assert 100 < rep.rate_now < 10000
        assert pr.total == 200

    def test_packet_credit(self):
        credit = PacketCredit(2)
        assert credit.acquire(0.01)
        assert credit.acquire(0.01)
        assert not credit.acquire(0.05)  # full
        credit.release()
        assert credit.acquire(0.01)
        assert credit.in_flight == 2


class TestMessages:
    def test_item_strobe_pull(self):
        from gr4_packet_modem_tpu.runtime.messages import ItemStrobe

        strobe = ItemStrobe(item=42, interval=0.02)
        t0 = time.monotonic()
        items = [strobe.next_item() for _ in range(3)]
        assert items == [42, 42, 42]
        # first item fires immediately, the next two wait one interval each
        # (0.9 factor: time.sleep may undershoot by the timer granularity)
        assert time.monotonic() - t0 >= 0.9 * 2 * 0.02

    def test_item_strobe_push(self):
        from gr4_packet_modem_tpu.runtime.messages import ItemStrobe

        got = []
        strobe = ItemStrobe(item="x", interval=0.02, callback=got.append)
        strobe.start()
        time.sleep(0.1)
        strobe.stop()
        assert len(got) >= 2

    def test_message_debug_stream(self):
        from gr4_packet_modem_tpu.runtime.messages import MessageDebugStream

        dbg = MessageDebugStream()
        dbg.push({"a": 1})
        assert dbg.drain(iter([{"b": 2}, {"c": 3}])) == 2
        assert dbg.messages() == [{"a": 1}, {"b": 2}, {"c": 3}]


class TestHostIo:
    def test_file_roundtrip(self):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "x.c64")
            data = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
            write_c64(path, data)
            np.testing.assert_array_equal(read_c64(path), data)
            blocks = list(stream_c64_blocks(path, 33))
            np.testing.assert_array_equal(np.concatenate(blocks), data)

    def test_native_ring(self):
        lib = native_lib()
        assert lib is not None, "native library should build in this image"
        ring = lib.pm_ring_create(256)
        msg = b"x" * 100
        assert lib.pm_ring_write(ring, msg, len(msg)) == 100
        buf = ctypes.create_string_buffer(256)
        assert lib.pm_ring_read(ring, buf, 256) == 100
        # wrap-around
        big = bytes(range(200))
        n = lib.pm_ring_write(ring, big, len(big))
        assert n == 200
        m = lib.pm_ring_read(ring, buf, 256)
        assert buf.raw[:m] == big
        lib.pm_ring_destroy(ring)
