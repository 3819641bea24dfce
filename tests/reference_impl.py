"""Sequential per-packet reference implementations (numpy, host).

These mirror the reference modem's algorithms step by step (one packet at a
time, explicit loops) and serve as the oracle for the batched kernels —
the same role VectorSource/VectorSink golden vectors play in the reference QA
suite (SURVEY.md §4). Deliberately simple and slow.
"""

from __future__ import annotations

import zlib

import numpy as np

from gr4_packet_modem_tpu.utils import constants as C
from gr4_packet_modem_tpu.utils.firdes import tx_rrc_taps
from gr4_packet_modem_tpu.utils.lfsr import additive_scrambler_keystream, glfsr_bits


def ldpc_encode_bytes(header4: np.ndarray) -> np.ndarray:
    """(128,32) LDPC + x2 repetition, per header_fec_encoder.hpp:93-115."""
    import os

    gen = np.load(
        os.path.join(
            os.path.dirname(__file__),
            "..",
            "gr4_packet_modem_tpu",
            "data",
            "header_ldpc_generator.npy",
        )
    )
    info = (
        (int(header4[0]) << 24)
        | (int(header4[1]) << 16)
        | (int(header4[2]) << 8)
        | int(header4[3])
    )
    out = list(header4)
    for k in range(12):
        pb = 0
        for l in range(8):
            row = int(gen[8 * k + l])
            pb = (pb << 1) | (bin(info & row).count("1") & 1)
        out.append(pb)
    return np.array(out + out, dtype=np.uint8)


def frame_bytes(payload: np.ndarray, packet_type: int = 0) -> np.ndarray:
    """Coded header || payload || CRC-32 bytes for one packet."""
    header = C.format_header(len(payload), packet_type)
    coded = ldpc_encode_bytes(header)
    crc = zlib.crc32(np.asarray(payload, np.uint8).tobytes())
    crc_bytes = np.array(
        [(crc >> 24) & 0xFF, (crc >> 16) & 0xFF, (crc >> 8) & 0xFF, crc & 0xFF],
        dtype=np.uint8,
    )
    return np.concatenate([coded, np.asarray(payload, np.uint8), crc_bytes])


def data_symbols(payload: np.ndarray, packet_type: int = 0) -> np.ndarray:
    """Scrambled QPSK data symbols of one packet."""
    fb = frame_bytes(payload, packet_type)
    bits = np.unpackbits(fb)
    ks = additive_scrambler_keystream(bits.size)
    bits = bits ^ ks
    idx = bits.reshape(-1, 2) @ np.array([2, 1])
    return np.asarray(C.QPSK_CONSTELLATION)[idx]


def burst_symbols(payload: np.ndarray, packet_index: int, packet_type: int = 0):
    """Full burst-mode symbol vector: sync || data || ramp-down || flush."""
    sync = np.asarray(C.BPSK_CONSTELLATION)[np.asarray(C.SYNCWORD)]
    data = data_symbols(payload, packet_type)
    nbits = C.RAMP_DOWN_BITS
    all_ramp = glfsr_bits(nbits * (packet_index + 1))
    ramp_bits = all_ramp[nbits * packet_index : nbits * (packet_index + 1)]
    ridx = ramp_bits.reshape(-1, 2) @ np.array([2, 1])
    ramp = np.asarray(C.QPSK_CONSTELLATION)[ridx]
    flush = np.zeros(C.RRC_FLUSH_SYMBOLS, np.complex64)
    return np.concatenate([sync, data, ramp, flush])


def interp_fir(symbols: np.ndarray, taps: np.ndarray, interp: int) -> np.ndarray:
    """Per-item interpolating FIR with zero initial history
    (interpolating_fir_filter.hpp:90-99)."""
    arm_len = -(-taps.size // interp)
    tp = np.zeros((interp, arm_len), dtype=np.float32)
    for j in range(interp):
        arm = taps[j::interp]
        tp[j, : arm.size] = arm
    hist = np.zeros(arm_len, dtype=np.complex64)
    out = np.zeros(symbols.size * interp, dtype=np.complex64)
    for s, x in enumerate(symbols):
        hist = np.roll(hist, 1)
        hist[0] = x
        for j in range(interp):
            out[s * interp + j] = np.dot(tp[j], hist)
    return out


def burst_ramps(sps: int = 4):
    ramp_samples = C.BURST_RAMP_SYMBOLS * sps
    offset = 4 * sps
    lead = np.sin(
        np.arange(1, offset + ramp_samples + 1)
        / (offset + ramp_samples)
        * 0.5
        * np.pi
    ).astype(np.float32)
    tr_len = C.RRC_FLUSH_SYMBOLS * sps - offset + ramp_samples
    trail = np.sin(np.arange(1, tr_len + 1) / tr_len * 0.5 * np.pi).astype(
        np.float32
    )[::-1].copy()
    return lead, trail


def burst_samples(payload: np.ndarray, packet_index: int, sps: int = 4,
                  packet_type: int = 0) -> np.ndarray:
    """Complete burst-mode TX of one packet: shaped RRC samples."""
    syms = burst_symbols(payload, packet_index, packet_type)
    taps = tx_rrc_taps(sps)
    samples = interp_fir(syms, taps, sps)
    lead, trail = burst_ramps(sps)
    samples[: lead.size] *= lead
    samples[-trail.size :] *= trail
    return samples


def stream_samples(payloads, sps: int = 4, packet_types=None) -> np.ndarray:
    """Stream-mode TX of a sequence of packets (continuous RRC filtering)."""
    sync = np.asarray(C.BPSK_CONSTELLATION)[np.asarray(C.SYNCWORD)]
    parts = []
    for i, p in enumerate(payloads):
        t = 0 if packet_types is None else packet_types[i]
        parts.append(sync)
        parts.append(data_symbols(p, t))
    syms = np.concatenate(parts)
    taps = tx_rrc_taps(sps)
    return interp_fir(syms, taps, sps)
