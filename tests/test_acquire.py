"""Acquisition unit tests: detection + parameter estimation accuracy.

Mirrors qa_syncword_detection.cpp but with quantitative checks of the
time/frequency/phase/amplitude estimates on synthetic signals with known
impairments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr4_packet_modem_tpu.models.channel import awgn, rotate
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.ops.acquire import (
    AcquisitionConfig,
    SyncwordAcquirer,
    modulated_syncword,
)
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat


def _signal(scale=1.0, cfo=0.0, offset=3000, total=16384, noise=0.0, seed=0):
    tx = Transmitter(TxConfig(max_payload_len=64))
    payload = np.arange(32, dtype=np.uint8)
    batch = PacketBatch.from_list([payload], max_len=64)
    s, l = tx.modulate_bursts(batch)
    x = np.zeros(total, np.complex64)
    n = int(l[0])
    x[offset : offset + n] = np.asarray(s)[0, :n] * scale
    xj = jnp.asarray(x)
    if cfo:
        xj = rotate(xj, cfo)
    if noise:
        xj = awgn(jax.random.PRNGKey(seed), xj, noise)
    return xj


class TestReplica:
    def test_modulated_syncword_shape(self):
        rep, self_corr = modulated_syncword(4)
        assert rep.size == 63 * 4 + 45
        assert self_corr > 0
        # replica is the RRC-shaped BPSK syncword: real-valued
        assert np.abs(rep.imag).max() < 1e-6

    def test_backends_agree(self):
        x = _signal(noise=0.01)
        for bins in [0, 2]:
            a_fft = SyncwordAcquirer(
                AcquisitionConfig(freq_bins=bins, backend="fft", max_detections=4)
            )
            a_conv = SyncwordAcquirer(
                AcquisitionConfig(freq_bins=bins, backend="conv", max_detections=4)
            )
            cf = np.asarray(a_fft.correlate(x))
            cc = np.asarray(a_conv.correlate(x))
            n = min(cf.shape[1], cc.shape[1])
            np.testing.assert_allclose(cf[:, :n], cc[:, :n], atol=2e-3)


class TestDetection:
    def test_clean_detection_parameters(self):
        offset = 3000
        x = _signal(scale=0.7, offset=offset)
        acq = SyncwordAcquirer(
            AcquisitionConfig(freq_bins=4, max_detections=4)
        )
        det = acq.acquire(x)
        valid = np.asarray(det.valid)
        assert valid[0]
        assert int(np.asarray(det.index)[0]) == offset
        # amplitude is measured in units of the unit-norm RX replica, so it is
        # the 0.7 scale times the TX pulse-shape norm (~1.13)
        amp = float(np.asarray(det.amplitude)[0])
        assert 0.6 < amp < 0.95
        assert abs(float(np.asarray(det.freq)[0])) < 1e-3
        assert abs(float(np.asarray(det.time_est)[0])) <= 0.5

    def test_cfo_estimate(self):
        for cfo in [0.006, -0.02]:
            x = _signal(cfo=cfo, noise=0.02)
            acq = SyncwordAcquirer(
                AcquisitionConfig(freq_bins=4, max_detections=4)
            )
            det = acq.acquire(x)
            assert np.asarray(det.valid)[0]
            est = float(np.asarray(det.freq)[0])
            # bin spacing is pi/297 ~ 0.0106 rad/sample; the quadratic
            # interpolation should land well inside half a bin
            assert abs(est - cfo) < 0.002, (cfo, est)

    def test_fractional_delay_estimate(self):
        # shift the burst by a fractional sample using the frequency domain
        tx_sig = np.asarray(_signal(offset=3000))
        for frac in [-0.3, 0.25]:
            spec = np.fft.fft(tx_sig)
            freqs = np.fft.fftfreq(tx_sig.size)
            shifted = np.fft.ifft(spec * np.exp(-2j * np.pi * freqs * frac))
            acq = SyncwordAcquirer(
                AcquisitionConfig(freq_bins=0, max_detections=4)
            )
            det = acq.acquire(jnp.asarray(shifted.astype(np.complex64)))
            valid = np.asarray(det.valid)
            assert valid.any()
            # the CFAR is purely relative, so numerically-tiny ringing in the
            # zero-padding can also fire; assert on the strongest detection
            amps = np.where(valid, np.asarray(det.amplitude), 0.0)
            best = int(np.argmax(amps))
            t_est = float(np.asarray(det.time_est)[best])
            idx = int(np.asarray(det.index)[best])
            total_delay = (idx - 3000) + t_est
            assert abs(total_delay - frac) < 0.15, (frac, idx, t_est)

    def test_no_false_alarms_on_noise(self):
        acq = SyncwordAcquirer(AcquisitionConfig(freq_bins=4, max_detections=8))
        x = awgn(jax.random.PRNGKey(5), jnp.zeros(16384, jnp.complex64), 1.0)
        det = acq.acquire(x)
        assert not np.asarray(det.valid).any()

    def test_esn0_estimate_reasonable(self):
        # Es/N0 = signal symbol energy vs noise; at sigma 0.05 and amplitude
        # ~0.65 the true Es/N0 is ~26 dB
        x = _signal(noise=0.05, seed=2)
        acq = SyncwordAcquirer(AcquisitionConfig(freq_bins=4, max_detections=4))
        det = acq.acquire(x)
        assert np.asarray(det.valid)[0]
        esn0 = float(np.asarray(det.esn0_db)[0])
        assert 15.0 < esn0 < 35.0


def test_fft_size_equivalence():
    """Detections are invariant to the overlap-save FFT size (the frame
    partitioning is an implementation detail of the correlation; fft 2048 is
    the reference's choice, larger sizes are a throughput knob)."""
    x = _signal(cfo=0.003, offset=4000, total=1 << 15, noise=0.03)
    base = SyncwordAcquirer(
        AcquisitionConfig(freq_bins=4, max_detections=4, fft_size=2048)
    ).acquire(x)
    for n in (4096, 8192):
        alt = SyncwordAcquirer(
            AcquisitionConfig(freq_bins=4, max_detections=4, fft_size=n)
        ).acquire(x)
        # correlation coverage length differs per fft size; compare the
        # detection actually found
        bi = int(np.argmax(np.asarray(base.valid)))
        ai = int(np.argmax(np.asarray(alt.valid)))
        assert bool(np.asarray(alt.valid)[ai])
        assert int(np.asarray(alt.index)[ai]) == int(np.asarray(base.index)[bi])
        np.testing.assert_allclose(
            float(np.asarray(alt.freq)[ai]),
            float(np.asarray(base.freq)[bi]), atol=1e-6,
        )
        np.testing.assert_allclose(
            float(np.asarray(alt.amplitude)[ai]),
            float(np.asarray(base.amplitude)[bi]), rtol=1e-4,
        )
        np.testing.assert_allclose(
            float(np.asarray(alt.time_est)[ai]),
            float(np.asarray(base.time_est)[bi]), atol=1e-4,
        )


def test_conv_bf16_equivalence():
    """bf16 convolution correlation: same detections, estimates within
    ~1%."""
    x = _signal(cfo=0.003, offset=4000, total=1 << 15, noise=0.03)
    det32 = SyncwordAcquirer(
        AcquisitionConfig(freq_bins=4, max_detections=4, backend="conv")
    ).acquire(x)
    det16 = SyncwordAcquirer(
        AcquisitionConfig(freq_bins=4, max_detections=4, backend="conv_bf16")
    ).acquire(x)
    i32 = int(np.argmax(np.asarray(det32.valid)))
    i16 = int(np.argmax(np.asarray(det16.valid)))
    assert bool(np.asarray(det16.valid)[i16])
    assert int(np.asarray(det16.index)[i16]) == int(np.asarray(det32.index)[i32])
    assert int(np.asarray(det16.freq_bin)[i16]) == int(
        np.asarray(det32.freq_bin)[i32]
    )
    np.testing.assert_allclose(
        float(np.asarray(det16.amplitude)[i16]),
        float(np.asarray(det32.amplitude)[i32]), rtol=2e-2,
    )
    np.testing.assert_allclose(
        float(np.asarray(det16.phase)[i16]),
        float(np.asarray(det32.phase)[i32]), atol=2e-2,
    )
    np.testing.assert_allclose(
        float(np.asarray(det16.freq)[i16]),
        float(np.asarray(det32.freq)[i32]), atol=2e-4,
    )


def _brute_force_detect(bp, w, d, threshold, fresh_lo=None, fresh_hi=None):
    """O(T*w) reference for chunked_peak_detect: the literal definition of
    the reference's running-best + history-median detection events."""
    tlen = bp.size
    events = []
    for t in range(w, tlen - w):
        if fresh_lo is not None and t < fresh_lo:
            continue
        if fresh_hi is not None and t >= fresh_hi:
            continue
        win = bp[t - w : t + w + 1]
        if bp[t] <= 0 or bp[t] < win.max():
            continue
        if t > 0 and bp[max(t - w, 0) : t].size and bp[t] <= bp[t - w : t].max():
            continue
        if 2 * int((win < bp[t] / threshold).sum()) < 2 * w + 1:
            continue
        events.append(t)
    events.sort(key=lambda t: -bp[t])
    return events[:d], len(events) > d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_peak_detect_matches_brute_force(seed):
    from gr4_packet_modem_tpu.ops.acquire import chunked_peak_detect

    rng = np.random.default_rng(seed)
    w, d, thr = 32, 6, 9.5
    tlen = 4096 + rng.integers(0, w)  # exercise the padded tail chunk
    bp = rng.random(tlen).astype(np.float32) * 0.1
    # plant peaks: some isolated (detected), some within w of each other
    # (suppressed), some near edges (excluded)
    for t in [40, 500, 529, 1200, 2000, 2000 + w, 3000, tlen - 10]:
        if t < tlen:
            bp[t] = 5.0 + rng.random()
    top_pow, top_idx, overflow = chunked_peak_detect(
        jnp.asarray(bp), w, d, thr
    )
    got = sorted(
        int(i) for p, i in zip(np.asarray(top_pow), np.asarray(top_idx))
        if p > 0
    )
    want, want_ovf = _brute_force_detect(bp, w, d, thr)
    assert got == sorted(want)
    assert bool(overflow) == want_ovf


def test_chunked_peak_detect_fresh_window():
    from gr4_packet_modem_tpu.ops.acquire import chunked_peak_detect

    rng = np.random.default_rng(7)
    w, d, thr = 32, 4, 9.5
    tlen = 2048
    bp = rng.random(tlen).astype(np.float32) * 0.1
    for t in [100, 400, 900, 1500]:
        bp[t] = 4.0
    lo, hi = 300, 1000
    top_pow, top_idx, _ = chunked_peak_detect(
        jnp.asarray(bp), w, d, thr, jnp.int32(lo), jnp.int32(hi)
    )
    got = sorted(
        int(i) for p, i in zip(np.asarray(top_pow), np.asarray(top_idx))
        if p > 0
    )
    want, _ = _brute_force_detect(bp, w, d, thr, lo, hi)
    assert got == sorted(want) == [400, 900]


def test_chunked_peak_detect_overflow_counts_all_passing():
    # more qualifying peaks than slots: top-d by power win, overflow set
    from gr4_packet_modem_tpu.ops.acquire import chunked_peak_detect

    w, d, thr = 16, 3, 4.0
    tlen = 1024
    bp = np.full(tlen, 0.01, np.float32)
    peaks = {100: 2.0, 200: 5.0, 300: 3.0, 400: 4.0, 500: 6.0}
    for t, v in peaks.items():
        bp[t] = v
    top_pow, top_idx, overflow = chunked_peak_detect(
        jnp.asarray(bp), w, d, thr
    )
    got = {int(i) for p, i in zip(np.asarray(top_pow), np.asarray(top_idx))
           if p > 0}
    assert got == {500, 200, 400}  # top-3 by power
    assert bool(overflow)


@pytest.mark.parametrize(
    "backend,resolved",
    [("auto", "fft"), ("fft", "fft"), ("conv", "conv"),
     ("conv_bf16", "conv_bf16")],
)
def test_backend_resolution(backend, resolved):
    """``auto`` means the overlap-save ``fft`` correlator on every
    platform."""
    cfg = AcquisitionConfig(backend=backend)
    assert cfg.resolved_backend() == resolved
    SyncwordAcquirer(cfg)  # accepted


@pytest.mark.parametrize("backend", ["fused", "fused_bf16", "other"])
def test_removed_backends_rejected(backend):
    with pytest.raises(ValueError, match="unknown acquisition backend"):
        SyncwordAcquirer(AcquisitionConfig(backend=backend))
