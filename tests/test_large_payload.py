"""Large-payload envelope: the reference accepts the
full u16 length range (packet_ingress.hpp:104, <= 65535 B). This exercises a
16 KiB payload end to end through TX -> channel -> RX, in both payload
carrier modes, and a 64 KiB TX modulation round-trip through the host
reference oracle."""

import jax
import numpy as np
import pytest

from gr4_packet_modem_tpu.models.channel import awgn, rotate
from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.utils.cplx import to_host
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

MAX_LEN = 16384


@pytest.mark.parametrize("carrier", ["costas", "vv"])
def test_16k_payload_loopback(carrier):
    tx = Transmitter(TxConfig(max_payload_len=MAX_LEN))
    rng = np.random.default_rng(7)
    payloads = [
        rng.integers(0, 256, 16384, dtype=np.uint8),
        rng.integers(0, 256, 5000, dtype=np.uint8),
    ]
    batch = PacketBatch.from_list(payloads, max_len=MAX_LEN)
    s, l = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
    x = rotate(stream, 0.002)
    x = awgn(jax.random.PRNGKey(3), x, 0.05)
    rx = Receiver(
        RxConfig(
            max_payload_len=MAX_LEN,
            max_detections=4,
            freq_bins=4,
            payload_carrier=carrier,
        )
    )
    res = rx.receive(to_host(x))
    acc = np.asarray(res.accepted)
    assert acc.sum() == len(payloads)
    data = np.asarray(res.data)
    lens = np.asarray(res.lengths)
    rows = np.nonzero(acc)[0]
    for row, p in zip(rows, payloads):
        assert lens[row] == p.size
        np.testing.assert_array_equal(data[row, : p.size], p)


@pytest.mark.parametrize("carrier", ["costas", "vv"])
def test_u16_max_payload_loopback(carrier):
    """Full u16 envelope: a 65,535-byte payload (the reference's hard limit,
    packet_ingress.hpp:104) decodes byte-exact through the full RX chain.
    262,156 payload symbols exercise the chunked extraction
    (symbol_chunk-sized lax.map) and, in costas mode, the gridded Pallas /
    long-scan carrier path that replaced the PALLAS_MAX_SYMBOLS cap."""
    max_len = 65535
    tx = Transmitter(TxConfig(max_payload_len=max_len))
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, max_len, dtype=np.uint8)
    batch = PacketBatch.from_list([payload], max_len=max_len)
    s, l = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
    x = rotate(stream, 0.001)
    x = awgn(jax.random.PRNGKey(5), x, 0.02)
    rx = Receiver(
        RxConfig(
            max_payload_len=max_len,
            max_detections=2,
            freq_bins=1,
            payload_carrier=carrier,
        )
    )
    res = rx.receive(to_host(x))
    acc = np.asarray(res.accepted)
    assert acc.sum() == 1
    row = int(np.nonzero(acc)[0][0])
    assert int(np.asarray(res.lengths)[row]) == max_len
    np.testing.assert_array_equal(
        np.asarray(res.data)[row, :max_len], payload
    )
