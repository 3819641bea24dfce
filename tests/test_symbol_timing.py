"""Symbol-timing edge cases at fractional-time boundaries.

Direct tests of the receiver's clock-phase handling against the reference
SymbolFilter semantics (symbol_filter.hpp:141-202): the PFB arm can only go
*forward* in time, so a negative ``time_est`` must (a) add one to the clock
phase / shift the base sample, (b) use ``time_est + 1`` for the arm, and
(c) adjust the syncword phase by ``-syncword_freq``. A dropped or
sign-flipped adjustment is a ~half-sample timing error: the matched filter
then samples near symbol transitions and the syncword EVM explodes — the
assertions here are tight enough that an injected off-by-one fails them.

The stimulus is a clean burst delayed by an exact *fractional* number of
samples (band-limited FFT phase-ramp delay — the RRC at 4 sps occupies
< 0.25 of Nyquist, so the delay is numerically exact), sweeping time_est
across both boundaries (±0.45, ±0.499) and interior points.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.utils import constants as C
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

PAYLOAD = (np.arange(96) % 256).astype(np.uint8)
OFFSET = 500
BUF = 8192


def _frac_delay(x: np.ndarray, d: float) -> np.ndarray:
    """Delay ``x`` by ``d`` samples (band-limited, exact for the RRC
    signal's < 0.25-Nyquist occupancy)."""
    n = 1 << int(np.ceil(np.log2(x.size + 256)))
    xp = np.zeros(n, np.complex128)
    xp[: x.size] = x
    f = np.fft.fftfreq(n)
    y = np.fft.ifft(np.fft.fft(xp) * np.exp(-2j * np.pi * f * d))
    return y[: x.size].astype(np.complex64)


@pytest.fixture(scope="module")
def rx():
    return Receiver(RxConfig(max_payload_len=128, max_detections=4, freq_bins=1))


@pytest.fixture(scope="module")
def clean_signal():
    tx = Transmitter(TxConfig(max_payload_len=128))
    batch = PacketBatch.from_list([PAYLOAD], max_len=128)
    s, l = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
    buf = np.zeros(BUF, np.complex64)
    buf[OFFSET : OFFSET + stream.size] = np.asarray(stream)
    return buf


@pytest.mark.parametrize(
    "delay", [-0.499, -0.45, -0.25, -0.05, 0.0, 0.05, 0.26, 0.45, 0.499]
)
def test_fractional_delay_decode_and_evm(rx, clean_signal, delay):
    x = _frac_delay(clean_signal, delay)
    fp = rx.front_pad
    xj = jnp.concatenate(
        [
            jnp.zeros(fp, jnp.complex64),
            jnp.asarray(x),
            jnp.zeros(rx.pad_tail(), jnp.complex64),
        ]
    )
    det = rx.acquirer.acquire(xj, index0=0)
    valid = np.asarray(det.valid)
    # the true syncword start is the earliest detection (row 0); later rows
    # may hold in-packet false hits that filter_detections suppresses
    assert valid[0]
    te = float(np.asarray(det.time_est)[0])
    # the acquisition's sub-sample estimate must reproduce the injected
    # fraction (mod 1 sample; at +-0.5 either side of the boundary is fine)
    err = (te - delay + 0.5) % 1.0 - 0.5
    assert abs(err) < 0.06, f"time_est {te} vs injected {delay}"
    hdr, corrected = rx.decode_headers(xj, det)
    assert bool(np.asarray(hdr.header_ok)[0])
    # wiped-off syncword after arm-matched filtering + Costas + amplitude
    # normalization is a unit pilot; a half-sample timing error (a broken
    # +-1 adjustment) costs ~10 dB of EVM and fails this bound
    sync = np.asarray(corrected)[0, : C.SYNCWORD_LEN]
    # correct timing measures <= 0.001 across the sweep; the injected
    # off-by-one mutation measures ~0.026 — 5x margin on both sides
    evm = float(np.mean(np.abs(sync - 1.0) ** 2))
    assert evm < 0.005, f"syncword EVM {evm:.4f} at delay {delay}"
    keep = rx.filter_detections(det, hdr)
    res = rx.decode_payloads(xj, det, hdr, keep)
    assert bool(np.asarray(res.accepted)[0])
    np.testing.assert_array_equal(
        np.asarray(res.data)[0, : PAYLOAD.size], PAYLOAD
    )


def test_negative_time_est_with_cfo(rx, clean_signal):
    """The neg-branch phase adjustment (syncword_phase -= syncword_freq,
    symbol_filter.hpp:152-156) under a CFO large enough to matter."""
    cfo = 0.006
    x = _frac_delay(clean_signal, -0.45)
    x = (x * np.exp(1j * cfo * np.arange(x.size))).astype(np.complex64)
    fp = rx.front_pad
    xj = jnp.concatenate(
        [
            jnp.zeros(fp, jnp.complex64),
            jnp.asarray(x),
            jnp.zeros(rx.pad_tail(), jnp.complex64),
        ]
    )
    det = rx.acquirer.acquire(xj, index0=0)
    hdr, corrected = rx.decode_headers(xj, det)
    assert bool(np.asarray(hdr.header_ok)[0])
    # under CFO the pilot loop pulls in the acquisition's residual frequency
    # over the syncword, so only the post-convergence tail is bounded (the
    # half-sample timing error of a broken neg-branch still explodes it);
    # the exact phase -= freq contract is pinned in test_timing_contract
    sync = np.asarray(corrected)[0, : C.SYNCWORD_LEN]
    tail_evm = float(np.mean(np.abs(sync[48:] - np.mean(sync[48:])) ** 2))
    assert tail_evm < 0.02
    keep = rx.filter_detections(det, hdr)
    res = rx.decode_payloads(xj, det, hdr, keep)
    assert bool(np.asarray(res.accepted)[0])


def test_timing_contract():
    """The _timing mapping itself, against the reference spec
    (symbol_filter.hpp:160-202): arm = clamp(round(32*te'), 0, 31) with
    te' = te + 1 and a one-sample base shift and phase -= freq for te < 0."""
    from gr4_packet_modem_tpu.ops.acquire import Detections

    rx = Receiver(RxConfig(max_payload_len=64, max_detections=8, freq_bins=1))
    te = np.array(
        [0.0, 0.2, 0.499, -0.2, -0.015625, -0.5, 0.5, -0.499], np.float32
    )
    d = te.size
    det = Detections(
        index=jnp.full(d, 1000, jnp.int32),
        valid=jnp.ones(d, bool),
        amplitude=jnp.ones(d, jnp.float32),
        phase=jnp.full(d, 0.3, jnp.float32),
        freq=jnp.full(d, 0.01, jnp.float32),
        freq_bin=jnp.zeros(d, jnp.int32),
        time_est=jnp.asarray(te),
        noise_power=jnp.zeros(d, jnp.float32),
        esn0_db=jnp.zeros(d, jnp.float32),
        overflow=jnp.asarray(False),
    )
    arm, n_base, phase0 = rx._timing(det)
    arm, n_base, phase0 = map(np.asarray, (arm, n_base, phase0))
    neg = te < 0
    te_adj = np.where(neg, te + 1.0, te)
    exp_arm = np.clip(np.round(32 * te_adj), 0, 31).astype(np.int32)
    np.testing.assert_array_equal(arm, exp_arm)
    np.testing.assert_array_equal(
        n_base, 1000 + rx.filter_delay - neg.astype(np.int32)
    )
    np.testing.assert_allclose(
        phase0, np.where(neg, 0.3 - 0.01, 0.3), rtol=1e-6
    )
