"""Batched CRC computation as a GF(2) matmul.

The reference computes CRCs with a sequential byte-at-a-time table loop
(crc.hpp:121-155). That is serial work, but a CRC is a GF(2)-affine
function of the message, which gives a fully parallel formulation:

With zero initial register value, the CRC state update per byte is *linear*
(s' = A s xor T[b], and T[0] = 0, A 0 = 0), so **leading zero bytes do not
change the CRC**. Therefore, for messages front-padded with zeros to a fixed
``max_len``:

    crc(msg, init, xorout) = lut_init[len] ^ (bits_frontpadded @ G) ^ xorout

where ``G`` is a fixed ``[8*max_len, 32]`` GF(2) matrix (one column per
message bit position) and ``lut_init[L] = A^L(init)`` accounts for the initial
register value being clocked through ``L`` message bytes. The matmul runs
batched over packets (exact: f32 accumulation of 0/1 products), the
mod-2 is one elementwise op, and the init term is a tiny per-length lookup.

This matches the reference CRC-32 (poly 0x4C11DB7, init/xorout 0xFFFFFFFF,
reflected in/out — i.e. zlib crc32) bit-for-bit; a generic parameterized host
implementation is also provided for tests and other CRC configurations.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import constants as C

__all__ = [
    "CrcRef", "crc32_ref", "CrcEngine", "make_crc32_engine",
    "BatchedCrcAppend", "BatchedCrcCheck",
]


class CrcRef:
    """Generic table-driven CRC (host/numpy), parameter-compatible with the
    reference Crc class (crc.hpp:67-155). Used as the test oracle and for
    host-side processing."""

    def __init__(
        self,
        num_bits: int = 32,
        poly: int = C.CRC32_POLY,
        initial_value: int = C.CRC32_INITIAL,
        final_xor: int = C.CRC32_FINAL_XOR,
        input_reflected: bool = True,
        result_reflected: bool = True,
    ):
        if num_bits < 8 or num_bits > 64:
            raise ValueError("CRC size must be between 8 and 64 bits")
        self.num_bits = num_bits
        self.mask = (1 << num_bits) - 1
        self.initial_value = initial_value & self.mask
        self.final_xor = final_xor & self.mask
        self.input_reflected = input_reflected
        self.result_reflected = result_reflected
        self.table = self._build_table(poly)

    def _reflect(self, word: int) -> int:
        ret = word & 1
        for _ in range(1, self.num_bits):
            word >>= 1
            ret = (ret << 1) | (word & 1)
        return ret

    def _build_table(self, poly: int) -> np.ndarray:
        """Each entry independently: clock one byte's 8 bits through the
        shift register (textbook byte-at-a-time table; the table is fully
        determined by the CRC spec)."""
        table = np.zeros(256, dtype=np.uint64)
        if self.input_reflected:
            # reflected convention: LSB-first register, reflected polynomial
            poly_r = self._reflect(poly)
            for byte in range(256):
                reg = byte
                for _ in range(8):
                    lsb = reg & 1
                    reg >>= 1
                    if lsb:
                        reg ^= poly_r
                table[byte] = reg & self.mask
        else:
            # forward convention: byte enters at the register's top
            top = 1 << (self.num_bits - 1)
            for byte in range(256):
                reg = byte << (self.num_bits - 8)
                for _ in range(8):
                    carry = reg & top
                    reg = (reg << 1) & self.mask
                    if carry:
                        reg ^= poly & self.mask
                table[byte] = reg
        return table

    def compute(self, data) -> int:
        rem = self.initial_value
        table = self.table
        if self.input_reflected:
            for byte in np.asarray(data, dtype=np.uint8):
                idx = (rem ^ int(byte)) & 0xFF
                rem = int(table[idx]) ^ (rem >> 8)
        else:
            for byte in np.asarray(data, dtype=np.uint8):
                idx = ((rem >> (self.num_bits - 8)) ^ int(byte)) & 0xFF
                rem = (int(table[idx]) ^ (rem << 8)) & self.mask
        if self.input_reflected != self.result_reflected:
            rem = self._reflect(rem)
        return rem ^ self.final_xor


def crc32_ref(data) -> int:
    """Reference CRC-32 of a byte sequence (host)."""
    return CrcRef().compute(data)


def _zero_byte_step(vec: int, table: np.ndarray) -> int:
    """Apply the linear 'clock one zero byte' map A to a 32-bit state vector
    (reflected convention): s' = T[s & 0xff] ^ (s >> 8)."""
    return int(table[vec & 0xFF]) ^ (vec >> 8)


class CrcEngine:
    """Batched reflected CRC-32 over ragged byte packets ``[B, max_len]``.

    ``data`` rows are left-aligned; ``lengths`` gives the valid byte count per
    row. ``max_len`` is a static bound. The engine front-pads (right-aligns)
    each row, unpacks to MSB-first bits and evaluates the GF(2) matmul.
    """

    def __init__(self, max_len: int):
        self.max_len = int(max_len)
        ref = CrcRef()
        table = ref.table
        # G matrix: column (p, k) = CRC (init 0, no xorout) of a max_len
        # message whose byte p has value with MSB-first bit k set.
        # Contribution of a byte at distance d from the end: A^d(T[b]).
        # Built back-to-front with one application of A per position.
        g = np.zeros((self.max_len, 8), dtype=np.uint64)
        basis = np.array([int(table[0x80 >> k]) for k in range(8)], dtype=np.uint64)
        for p in range(self.max_len - 1, -1, -1):
            g[p] = basis
            basis = np.array(
                [_zero_byte_step(int(v), table) for v in basis], dtype=np.uint64
            )
        # keep G packed as uint32 rows (one word per message bit position);
        # the f32 expansion happens on-device inside the jit. This keeps the
        # embedded literal at 4 bytes/row instead of 128.
        self._g_packed = g.reshape(self.max_len * 8).astype(np.uint32)
        # init contribution LUT: A^L(init) for L = 0..max_len
        lut = np.zeros(self.max_len + 1, dtype=np.uint32)
        v = ref.initial_value
        for L in range(self.max_len + 1):
            lut[L] = v
            v = _zero_byte_step(v, table)
        self._init_lut = lut
        self._final_xor = np.uint32(ref.final_xor)

    @partial(jax.jit, static_argnums=0)
    def compute(self, data: jax.Array, lengths: jax.Array) -> jax.Array:
        """CRC-32 of each row. data: uint8 [B, max_len] left-aligned;
        lengths: int32 [B]. Returns uint32 [B]."""
        max_len = self.max_len
        # right-align each row (front-pad with zeros)
        rolled = jax.vmap(lambda row, n: jnp.roll(row, max_len - n))(
            data, lengths.astype(jnp.int32)
        )
        # mask out anything beyond length (defensive: garbage in padding)
        idx = jnp.arange(max_len, dtype=jnp.int32)
        valid = idx[None, :] >= (max_len - lengths[:, None])
        rolled = jnp.where(valid, rolled, 0)
        # unpack MSB-first bits -> [B, 8*max_len]
        shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
        bits = ((rolled[..., None] >> shifts) & 1).reshape(rolled.shape[0], -1)
        gbits = (
            (jnp.asarray(self._g_packed)[:, None]
             >> jnp.arange(32, dtype=jnp.uint32)[None, :]) & 1
        ).astype(jnp.float32)  # [8*max_len, 32], expanded on device
        # 0/1 operands with f32 accumulation of at most 8*max_len terms
        # (< 2^24): exact at any matmul precision, TF32 included, since TF32
        # rounds only the operands and 0/1 are exact in it
        acc = jnp.dot(
            bits.astype(jnp.float32), gbits, preferred_element_type=jnp.float32
        )
        parity = (acc.astype(jnp.int32) & 1).astype(jnp.uint32)  # [B, 32]
        crc_raw = jnp.sum(parity << jnp.arange(32, dtype=jnp.uint32)[None, :], axis=1)
        return crc_raw ^ jnp.asarray(self._init_lut)[lengths] ^ self._final_xor


@lru_cache(maxsize=8)
def make_crc32_engine(max_len: int) -> CrcEngine:
    return CrcEngine(max_len)


class BatchedCrcAppend:
    """Batched CrcAppend block equivalent with full option parity
    (crc_append.hpp:66-73): the CRC is computed over ``data[skip:]`` of each
    packet and appended big-endian, or byte-reversed when
    ``swap_endianness``. Packets not longer than ``skip_header_bytes`` pass
    through unchanged (crc_append.hpp:254-258)."""

    def __init__(
        self,
        max_len: int,
        swap_endianness: bool = False,
        skip_header_bytes: int = 0,
    ):
        self.max_len = int(max_len)
        self.swap_endianness = bool(swap_endianness)
        self.skip = int(skip_header_bytes)
        self._engine = make_crc32_engine(self.max_len)

    @partial(jax.jit, static_argnums=0)
    def append(self, data: jax.Array, lengths: jax.Array):
        """data: uint8 [B, max_len] left-aligned; lengths: int32 [B].
        Returns (out [B, max_len+4], out_lengths [B])."""
        lengths = lengths.astype(jnp.int32)
        body_len = jnp.maximum(lengths - self.skip, 0)
        body = data[:, self.skip :] if self.skip else data
        # mask padding defensively, then CRC the ragged body
        pos = jnp.arange(body.shape[1], dtype=jnp.int32)[None, :]
        body = jnp.where(pos < body_len[:, None], body, 0)
        crc = self._engine.compute(
            jnp.pad(body, ((0, 0), (0, self.max_len - body.shape[1]))),
            jnp.minimum(body_len, self.max_len),
        )
        cb = crc_bytes_be(crc)  # [B, 4] big-endian
        if self.swap_endianness:
            cb = cb[:, ::-1]
        too_short = lengths <= self.skip
        out = jnp.pad(data, ((0, 0), (0, C.CRC_NUM_BYTES)))
        # place CRC bytes at positions length..length+3 (scatter-free)
        jpos = jnp.arange(out.shape[1], dtype=jnp.int32)[None, :]
        for i in range(C.CRC_NUM_BYTES):
            sel = jpos == (lengths + i)[:, None]
            out = jnp.where(
                sel & ~too_short[:, None], cb[:, i : i + 1], out
            )
        out_lengths = jnp.where(
            too_short, lengths, lengths + C.CRC_NUM_BYTES
        )
        return out.astype(jnp.uint8), out_lengths


class BatchedCrcCheck:
    """Batched CrcCheck block equivalent (crc_check.hpp): verifies the
    trailing CRC over ``data[skip:]``, optionally stripping it. Returns the
    ok mask; callers drop failed packets (the reference forwards only
    passing packets)."""

    def __init__(
        self,
        max_len: int,
        swap_endianness: bool = False,
        skip_header_bytes: int = 0,
        discard_crc: bool = True,
    ):
        self.max_len = int(max_len)  # max length INCLUDING the CRC
        self.swap_endianness = bool(swap_endianness)
        self.skip = int(skip_header_bytes)
        self.discard_crc = bool(discard_crc)
        self._engine = make_crc32_engine(self.max_len)

    @partial(jax.jit, static_argnums=0)
    def check(self, data: jax.Array, lengths: jax.Array):
        """Returns (ok [B] bool, out_data, out_lengths) with the CRC
        stripped when ``discard_crc``."""
        lengths = lengths.astype(jnp.int32)
        body_end = jnp.maximum(lengths - C.CRC_NUM_BYTES, 0)
        body_len = jnp.maximum(body_end - self.skip, 0)
        body = data[:, self.skip :] if self.skip else data
        pos = jnp.arange(body.shape[1], dtype=jnp.int32)[None, :]
        body = jnp.where(pos < body_len[:, None], body, 0)
        crc = self._engine.compute(
            jnp.pad(body, ((0, 0), (0, self.max_len - body.shape[1]))),
            jnp.minimum(body_len, self.max_len),
        )
        # received CRC bytes at body_end..body_end+3 via iota select
        jpos = jnp.arange(data.shape[1], dtype=jnp.int32)
        rx = [
            jnp.sum(
                data.astype(jnp.int32)
                * (jpos[None, :] == (body_end + i)[:, None]),
                axis=1,
            ).astype(jnp.uint32)
            for i in range(C.CRC_NUM_BYTES)
        ]
        if self.swap_endianness:
            rx = rx[::-1]
        crc_rx = (rx[0] << 24) | (rx[1] << 16) | (rx[2] << 8) | rx[3]
        ok = (crc == crc_rx) & (lengths > self.skip + C.CRC_NUM_BYTES)
        if self.discard_crc:
            mask = jnp.arange(data.shape[1], dtype=jnp.int32)[None, :]
            out = jnp.where(mask < body_end[:, None], data, 0)
            return ok, out.astype(jnp.uint8), body_end
        return ok, data, lengths


def crc_bytes_be(crc: jax.Array) -> jax.Array:
    """Split uint32 CRCs [B] into 4 big-endian bytes [B, 4] (the order
    CrcAppend uses with swap_endianness=false, crc_append.hpp:175-183)."""
    shifts = jnp.array([24, 16, 8, 0], dtype=jnp.uint32)
    return ((crc[:, None] >> shifts) & 0xFF).astype(jnp.uint8)
