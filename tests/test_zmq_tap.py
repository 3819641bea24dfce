"""End-to-end ZMQ monitoring-tap test.

Mirrors the reference's live-constellation path: the receiver publishes
post-Costas header/payload symbols per accepted packet on ZMQ PUB sockets
(packet_receiver.hpp:159-189, zmq_pdu_pub_sink.hpp) and a subscriber (the
headless core of scripts/plot_symbols.py) receives them and computes MER.
"""

import os
import sys
import time

import numpy as np
import pytest

from gr4_packet_modem_tpu.io.zmq_pub import ZmqPduPubSink, have_zmq
from gr4_packet_modem_tpu.models.receiver import RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.runtime.streaming import (
    StreamingReceiver,
    StreamingTransmitter,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from plot_symbols import mer_db  # noqa: E402


@pytest.mark.skipif(not have_zmq(), reason="pyzmq not available")
def test_zmq_symbol_taps_end_to_end():
    import zmq

    hdr_port, pay_port = 15800, 15801
    header_tap = ZmqPduPubSink(f"tcp://127.0.0.1:{hdr_port}")
    payload_tap = ZmqPduPubSink(f"tcp://127.0.0.1:{pay_port}")

    ctx = zmq.Context.instance()
    subs = []
    for port in (hdr_port, pay_port):
        s = ctx.socket(zmq.SUB)
        s.connect(f"tcp://127.0.0.1:{port}")
        s.setsockopt(zmq.SUBSCRIBE, b"")
        s.setsockopt(zmq.RCVTIMEO, 5000)
        subs.append(s)
    time.sleep(0.2)  # PUB/SUB join latency

    tx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=256)))
    payloads = [(np.arange(n) % 256).astype(np.uint8) for n in [100, 200]]
    sig = tx.send_burst(payloads)
    rx = StreamingReceiver(
        RxConfig(max_payload_len=256, max_detections=8),
        block=4096,
        header_tap=header_tap,
        payload_tap=payload_tap,
    )
    got = rx.process(np.asarray(sig, np.complex64))
    got += rx.flush()
    assert len(got) == len(payloads)

    for sub, expect_lens in zip(
        subs,
        ([128, 128], [4 * (100 + 4), 4 * (200 + 4)]),
    ):
        for expect_len in expect_lens:
            msg = sub.recv()
            syms = np.frombuffer(msg, np.complex64)
            assert syms.size == expect_len
            # clean channel: near-perfect constellation
            assert mer_db(syms) > 20.0
        sub.close(0)
    header_tap.close()
    payload_tap.close()
