"""Batched packet transmitter.

Re-design of the reference TX composite ``PacketTransmitterPdu``
(packet_transmitter_pdu.hpp:30-406). Where the reference wires ~15 dataflow
blocks (ingress -> CRC append / header format -> header FEC -> mux -> unpack
-> scramble -> pack -> QPSK map + syncword BPSK + GLFSR ramp-down -> symbol
mux -> interpolating RRC FIR -> burst shaper) into a per-item scheduler, this
implementation evaluates the whole chain as one jitted batched program over a
ragged packet batch:

1. header build + (128,32) LDPC + repetition: tiny GF(2) matmuls
2. payload CRC-32: one GF(2) matmul (ops/crc.py)
3. scramble: precomputed keystream XOR
4. QPSK mapping: gather
5. burst assembly: static-offset concatenation + per-packet dynamic updates
6. RRC x4 interpolation: polyphase window matmul (each burst starts from a
   flushed filter — guaranteed by the 11 zero flush symbols of the previous
   burst, packet_transmitter_pdu.hpp:209,249)
7. burst shaping: leading ramp at a static offset, trailing ramp at a
   per-packet dynamic offset (ramps per packet_transmitter_pdu.hpp:300-319)

Outputs are sample bursts ``[B, max_samples]`` with per-burst lengths, or a
contiguous sample stream for stream mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import crc as crc_ops
from ..ops import ldpc
from ..ops.fir import interpolating_fir, stream_interpolating_fir
from ..ops.packing import bytes_to_bits, map_symbols, pack_bits
from ..ops.scramble import scramble_bits
from ..utils import constants as C
from ..utils.firdes import tx_rrc_taps
from ..utils.lfsr import glfsr_bits
from ..utils.ragged import PacketBatch, ragged_concat

__all__ = ["TxConfig", "Transmitter"]


@dataclass(frozen=True)
class TxConfig:
    samples_per_symbol: int = 4
    stream_mode: bool = False
    max_payload_len: int = 1536  # static bound on payload bytes per packet
    max_packets_glfsr: int = 4096  # precomputed ramp-down bit budget


def _burst_ramps(sps: int) -> tuple[np.ndarray, np.ndarray]:
    """Leading/trailing amplitude ramps (packet_transmitter_pdu.hpp:300-319)."""
    ramp_samples = C.BURST_RAMP_SYMBOLS * sps
    offset = 4 * sps  # RRC group-delay compensation
    lead = np.sin(
        (np.arange(1, offset + ramp_samples + 1) / (offset + ramp_samples))
        * 0.5
        * np.pi
    ).astype(np.float32)
    tr_len = C.RRC_FLUSH_SYMBOLS * sps - offset + ramp_samples
    trail = np.sin(
        (np.arange(1, tr_len + 1) / tr_len) * 0.5 * np.pi
    ).astype(np.float32)[::-1].copy()
    return lead, trail


class Transmitter:
    """Batched packet transmitter. One instance per static configuration."""

    def __init__(self, config: TxConfig = TxConfig()):
        self.config = config
        sps = config.samples_per_symbol
        self.taps = tx_rrc_taps(sps)
        self.lead_ramp, self.trail_ramp = _burst_ramps(sps)
        lmax = config.max_payload_len
        # frame = coded header (32B) + payload + CRC (4B)
        self.max_frame_bytes = C.HEADER_CODED_BYTES + lmax + C.CRC_NUM_BYTES
        self.max_data_syms = 4 * self.max_frame_bytes
        self.max_burst_syms = (
            C.SYNCWORD_LEN
            + self.max_data_syms
            + C.RAMP_DOWN_SYMBOLS
            + C.RRC_FLUSH_SYMBOLS
        )
        self.max_stream_syms = C.SYNCWORD_LEN + self.max_data_syms
        self._crc = crc_ops.make_crc32_engine(lmax)
        # ramp-down GLFSR bit reservoir, packed one u32 word per packet
        # (18 bits each) so the jit-embedded literal stays small
        nbits = C.RAMP_DOWN_BITS * config.max_packets_glfsr
        rb = glfsr_bits(nbits).reshape(
            config.max_packets_glfsr, C.RAMP_DOWN_BITS
        ).astype(np.uint32)
        self._ramp_bits_packed = (
            rb << np.arange(C.RAMP_DOWN_BITS, dtype=np.uint32)[None, :]
        ).sum(axis=1, dtype=np.uint32)
        # complex constants stay numpy: embedded as literals at trace time
        self._sync_syms = np.asarray(C.BPSK_CONSTELLATION)[np.asarray(C.SYNCWORD)]
        self._qpsk = np.asarray(C.QPSK_CONSTELLATION)

    # ---------------------------------------------------------------- symbols

    def _frame_symbols(self, packets: PacketBatch) -> tuple[jax.Array, jax.Array]:
        """Scrambled QPSK data symbols (header+payload+CRC) per packet.

        Returns ``(syms [B, max_data_syms], data_sym_lens [B])``.
        """
        data = packets.data
        lens = packets.lengths.astype(jnp.int32)
        types = (
            packets.types
            if packets.types is not None
            else jnp.zeros_like(lens)
        )
        b = data.shape[0]
        lmax = self.config.max_payload_len
        # --- header path (header_formatter.hpp:110-113 + LDPC + repetition)
        header = jnp.stack(
            [
                (lens >> 8).astype(jnp.uint8),
                (lens & 0xFF).astype(jnp.uint8),
                jnp.where(types == int(C.PacketType.IDLE), 0x01, 0x00).astype(
                    jnp.uint8
                ),
                jnp.full((b,), C.HEADER_SPARE, dtype=jnp.uint8),
            ],
            axis=-1,
        )  # [B, 4]
        coded_header_bits = ldpc.encode_header(bytes_to_bits(header))  # [B, 256]
        # --- payload path: CRC append (crc_append.hpp Pdu spec.)
        crc = self._crc.compute(data, lens)
        crc_b = crc_ops.crc_bytes_be(crc)  # [B, 4]
        payload_crc = jnp.concatenate(
            [data, jnp.zeros((b, C.CRC_NUM_BYTES), jnp.uint8)], axis=-1
        )
        payload_crc = jax.vmap(
            lambda row, n, cb: jax.lax.dynamic_update_slice(row, cb, (n,))
        )(payload_crc, lens, crc_b)  # [B, lmax+4]
        # --- mux header||payload (packet_mux), unpack, scramble, pack, map
        payload_bits = bytes_to_bits(payload_crc)  # [B, 8*(lmax+4)]
        frame_bits = jnp.concatenate([coded_header_bits, payload_bits], axis=-1)
        frame_bits = scramble_bits(frame_bits)
        sym_idx = pack_bits(frame_bits, 2)  # [B, 4*(32+lmax+4)]
        syms = map_symbols(sym_idx, self._qpsk)
        data_sym_lens = 4 * (C.HEADER_CODED_BYTES + lens + C.CRC_NUM_BYTES)
        return syms, data_sym_lens

    # ------------------------------------------------------------- burst mode

    @partial(jax.jit, static_argnums=0)
    def modulate_bursts(
        self, packets: PacketBatch, packet_index0: jax.Array = 0
    ) -> tuple[jax.Array, jax.Array]:
        """Full burst-mode TX: packets -> shaped sample bursts.

        ``packet_index0``: index of the first packet in the GLFSR ramp-down
        sequence (the GLFSR state persists across packets in the reference,
        so packet p consumes ramp bits [18p, 18p+18)).

        Returns ``(samples [B, max_burst_syms*sps] complex64,
        sample_lens [B])``.
        """
        sps = self.config.samples_per_symbol
        data_syms, data_sym_lens = self._frame_symbols(packets)
        b = data_syms.shape[0]
        # ramp-down symbols per packet
        pidx = packet_index0 + jnp.arange(b, dtype=jnp.int32)
        packed = jnp.asarray(self._ramp_bits_packed)[
            pidx % self.config.max_packets_glfsr
        ]
        ramp_bits = (
            (packed[:, None] >> jnp.arange(C.RAMP_DOWN_BITS, dtype=jnp.uint32))
            & 1
        ).astype(jnp.uint8)
        ramp_syms = map_symbols(pack_bits(ramp_bits, 2), self._qpsk)  # [B, 9]
        # assemble: sync(64) || data || ramp(9) || flush(11 zeros)
        total_syms = jnp.zeros((b, self.max_burst_syms), jnp.complex64)
        total_syms = total_syms.at[:, : C.SYNCWORD_LEN].set(self._sync_syms[None])
        total_syms = jax.lax.dynamic_update_slice_in_dim(
            total_syms, data_syms, C.SYNCWORD_LEN, axis=1
        )
        # mask data symbols beyond each packet's length, then place ramp
        # (mask by multiply: real mask times complex symbols)
        pos = jnp.arange(self.max_burst_syms, dtype=jnp.int32)[None, :]
        data_end = C.SYNCWORD_LEN + data_sym_lens[:, None]
        total_syms = total_syms * (pos < data_end).astype(jnp.float32)
        total_syms = jax.vmap(
            lambda row, n, r: jax.lax.dynamic_update_slice(row, r, (n,))
        )(total_syms, C.SYNCWORD_LEN + data_sym_lens, ramp_syms)
        sym_lens = (
            C.SYNCWORD_LEN
            + data_sym_lens
            + C.RAMP_DOWN_SYMBOLS
            + C.RRC_FLUSH_SYMBOLS
        )
        # RRC interpolation (flushed history at burst start)
        samples = interpolating_fir(total_syms, self.taps, sps)
        sample_lens = sym_lens * sps
        # burst shaping
        lead = jnp.asarray(self.lead_ramp)
        samples = samples.at[:, : lead.shape[0]].multiply(lead[None])
        trail = jnp.asarray(self.trail_ramp)
        tl = trail.shape[0]

        def shape_tail(row, n):
            seg = jax.lax.dynamic_slice(row, (n - tl,), (tl,))
            return jax.lax.dynamic_update_slice(row, seg * trail, (n - tl,))

        samples = jax.vmap(shape_tail)(samples, sample_lens)
        # zero out anything past the burst end (padding hygiene)
        spos = jnp.arange(samples.shape[1], dtype=jnp.int32)[None, :]
        samples = samples * (spos < sample_lens[:, None]).astype(jnp.float32)
        return samples, sample_lens

    # ------------------------------------------------------------ stream mode

    @partial(jax.jit, static_argnums=(0, 2))
    def modulate_stream_symbols(
        self, packets: PacketBatch, out_syms: int
    ) -> tuple[jax.Array, jax.Array]:
        """Stream-mode symbol assembly: sync || data per packet, concatenated
        back-to-back into one symbol stream of static size ``out_syms``.

        Returns ``(symbols [out_syms], total_syms)``.
        """
        data_syms, data_sym_lens = self._frame_symbols(packets)
        b = data_syms.shape[0]
        per_pkt = jnp.zeros((b, self.max_stream_syms), jnp.complex64)
        per_pkt = per_pkt.at[:, : C.SYNCWORD_LEN].set(self._sync_syms[None])
        per_pkt = jax.lax.dynamic_update_slice_in_dim(
            per_pkt, data_syms, C.SYNCWORD_LEN, axis=1
        )
        pos = jnp.arange(self.max_stream_syms, dtype=jnp.int32)[None, :]
        lens = C.SYNCWORD_LEN + data_sym_lens
        per_pkt = per_pkt * (pos < lens[:, None]).astype(jnp.float32)
        return ragged_concat(per_pkt, lens, out_syms)

    def modulate_stream(
        self, packets: PacketBatch, out_syms: int, carry: jax.Array | None = None
    ) -> tuple[jax.Array, jax.Array, jax.Array]:
        """Stream-mode TX: symbol stream -> RRC-interpolated sample stream.

        Returns ``(carry, samples [out_syms*sps], total_samples)``. ``carry``
        holds FIR history across calls.
        """
        sps = self.config.samples_per_symbol
        arm_len = -(-self.taps.size // sps)
        if carry is None:
            carry = jnp.zeros(arm_len - 1, jnp.complex64)
        syms, total = self.modulate_stream_symbols(packets, out_syms)
        carry, samples = stream_interpolating_fir(carry, syms, self.taps, sps)
        return carry, samples, total * sps


@lru_cache(maxsize=4)
def make_transmitter(
    max_payload_len: int = 1536, stream_mode: bool = False, sps: int = 4
) -> Transmitter:
    return Transmitter(
        TxConfig(
            samples_per_symbol=sps,
            stream_mode=stream_mode,
            max_payload_len=max_payload_len,
        )
    )
