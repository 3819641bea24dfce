"""Full TX -> channel -> RX loopback bit-exactness oracle.

Mirrors the reference's primary correctness oracle qa_loopback
(test/qa_loopback.cpp:19-141): a set of packets with lengths spanning
10..4096 bytes is transmitted, impaired with CFO/AWGN (and additionally SFO
here), received, and the decoded payload bytes must be exactly equal to the
transmitted ones, for {CFO 0, +0.006, -0.02 rad/sample} x {burst, stream}.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr4_packet_modem_tpu.models.channel import awgn, rotate, sfo
from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.utils import constants as C
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

LENGTHS = [10, 25, 100, 1500, 27, 38, 243, 514, 1500, 1500, 1024, 1024, 42, 34]
PAYLOADS = [(np.arange(n) % 256).astype(np.uint8) for n in LENGTHS]
NOISE_AMPLITUDE = 0.05  # qa_loopback.cpp:66


def _tx_burst(payloads, max_len):
    tx = Transmitter(TxConfig(max_payload_len=max_len))
    batch = PacketBatch.from_list(payloads, max_len=max_len)
    samples, slens = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(samples, slens, int(np.sum(np.asarray(slens))))
    return stream


def _tx_stream(payloads, max_len):
    tx = Transmitter(TxConfig(max_payload_len=max_len, stream_mode=True))
    batch = PacketBatch.from_list(payloads, max_len=max_len)
    out_syms = sum(C.stream_symbols(len(p)) for p in payloads) + 16  # FIR flush
    _, stream, _ = tx.modulate_stream(batch, out_syms)
    return stream


def _assert_loopback(stream, payloads, max_len, key=1):
    rx = Receiver(RxConfig(max_payload_len=max_len, max_detections=32))
    res = rx.receive(np.asarray(stream))
    acc = np.asarray(res.accepted)
    lens = np.asarray(res.lengths)
    data = np.asarray(res.data)
    got = [data[i, : lens[i]] for i in range(len(acc)) if acc[i]]
    assert len(got) == len(payloads), f"decoded {len(got)}/{len(payloads)}"
    for g, e in zip(got, payloads):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("cfo", [0.0, 0.006, -0.02])
def test_loopback_burst(cfo):
    stream = _tx_burst(PAYLOADS, 1536)
    x = awgn(jax.random.PRNGKey(1), rotate(stream, cfo), NOISE_AMPLITUDE)
    _assert_loopback(x, PAYLOADS, 1536)


@pytest.mark.parametrize("cfo", [0.0, 0.006, -0.02])
def test_loopback_stream(cfo):
    stream = _tx_stream(PAYLOADS, 1536)
    x = awgn(jax.random.PRNGKey(2), rotate(stream, cfo), NOISE_AMPLITUDE)
    _assert_loopback(x, PAYLOADS, 1536)


def test_loopback_burst_4096():
    """Long-packet case (the reference test truncates this one only because
    its scheduler stops after 3 s; here it must decode fully)."""
    payloads = PAYLOADS + [(np.arange(4096) % 256).astype(np.uint8)]
    stream = _tx_burst(payloads, 4096)
    x = awgn(jax.random.PRNGKey(3), rotate(stream, 0.006), NOISE_AMPLITUDE)
    _assert_loopback(x, payloads, 4096)


def test_loopback_transceiver_operating_point():
    """The BASELINE transceiver config: Es/N0-ish noise, CFO 0.005, SFO
    1.2 ppm, burst mode."""
    stream = _tx_burst(PAYLOADS, 1536)
    x = sfo(stream, 1.2)
    x = rotate(x, 0.005)
    x = awgn(jax.random.PRNGKey(4), x, NOISE_AMPLITUDE)
    _assert_loopback(x, PAYLOADS, 1536)


def test_idle_packets_filtered():
    """IDLE packets decode but are dropped by the packet-type filter
    (packet_type_filter.hpp)."""
    payloads = [PAYLOADS[0], np.zeros(256, np.uint8), PAYLOADS[1]]
    types = [0, int(C.PacketType.IDLE), 0]
    tx = Transmitter(TxConfig(max_payload_len=512))
    batch = PacketBatch.from_list(payloads, max_len=512, types=types)
    samples, slens = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(samples, slens, int(np.sum(np.asarray(slens))))
    x = awgn(jax.random.PRNGKey(5), jnp.asarray(stream), NOISE_AMPLITUDE)
    rx = Receiver(RxConfig(max_payload_len=512, max_detections=16))
    res = rx.receive(np.asarray(x))
    acc = np.asarray(res.accepted)
    lens = np.asarray(res.lengths)
    data = np.asarray(res.data)
    got = [data[i, : lens[i]] for i in range(len(acc)) if acc[i]]
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], PAYLOADS[0])
    np.testing.assert_array_equal(got[1], PAYLOADS[1])
    # the idle packet passed CRC but was filtered
    crc_ok = np.asarray(res.crc_ok)
    assert crc_ok.sum() == 3


@pytest.mark.parametrize("cfo", [0.0, 0.006, -0.02])
def test_loopback_burst_vv_carrier(cfo):
    """Feed-forward (V&V) payload carrier tracking decodes the same packets
    (within-SNR equivalence of the scan-free estimator)."""
    from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig

    stream = _tx_burst(PAYLOADS, 1536)
    x = awgn(jax.random.PRNGKey(6), rotate(stream, cfo), NOISE_AMPLITUDE)
    rx = Receiver(
        RxConfig(max_payload_len=1536, max_detections=32, payload_carrier="vv")
    )
    res = rx.receive(np.asarray(x))
    acc = np.asarray(res.accepted)
    lens = np.asarray(res.lengths)
    data = np.asarray(res.data)
    got = [data[i, : lens[i]] for i in range(len(acc)) if acc[i]]
    assert len(got) == len(PAYLOADS)
    for g, e in zip(got, PAYLOADS):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("backend", ["fft", "conv"])
def test_loopback_burst_acquisition_backend(backend):
    """Byte-exact decode with each correlation backend of the acquisition
    (ops/acquire.py) — end-to-end equivalence beyond the detection-level
    tests in test_acquire.py."""
    payloads = PAYLOADS[:6]
    stream = _tx_burst(payloads, 1536)
    x = awgn(jax.random.PRNGKey(5), rotate(stream, 0.006), NOISE_AMPLITUDE)
    rx = Receiver(
        RxConfig(
            max_payload_len=1536,
            max_detections=16,
            acquisition_backend=backend,
        )
    )
    res = rx.receive(np.asarray(x))
    acc = np.asarray(res.accepted)
    lens = np.asarray(res.lengths)
    data = np.asarray(res.data)
    got = [data[i, : lens[i]] for i in range(len(acc)) if acc[i]]
    assert len(got) == len(payloads)
    for g, e in zip(got, payloads):
        np.testing.assert_array_equal(g, e)


def test_loopback_forced_pallas_kernels():
    """use_pallas=True with pallas_interpret=True runs the Costas kernel
    (ops/costas_gpu.py) in the Pallas interpreter for both the header and
    the payload pass, end to end on the CPU."""
    payloads = [(np.arange(n) % 256).astype(np.uint8) for n in (40, 120)]
    tx = Transmitter(TxConfig(max_payload_len=128))
    batch = PacketBatch.from_list(payloads, max_len=128)
    samples, slens = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(samples, slens, int(np.sum(np.asarray(slens))))
    x = awgn(jax.random.PRNGKey(1), rotate(stream, 0.004), NOISE_AMPLITUDE)
    rx = Receiver(
        RxConfig(
            max_payload_len=128, max_detections=4, use_pallas=True,
            pallas_interpret=True,
        )
    )
    res = rx.receive(np.asarray(x))
    acc = np.asarray(res.accepted)
    data = np.asarray(res.data)
    lens = np.asarray(res.lengths)
    got = [data[i, : lens[i]] for i in range(len(acc)) if acc[i]]
    assert len(got) == len(payloads)
    for g, e in zip(got, payloads):
        np.testing.assert_array_equal(g, e)
