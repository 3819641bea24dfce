"""Vectorized CCSDS additive scrambling.

The scrambler LFSR restarts at every packet (TX: per PDU,
additive_scrambler.hpp:128-131; RX: on the "header_start" reset tag,
packet_receiver.hpp:131-135), so the keystream seen by any packet is the same
fixed bit sequence. The keystream is precomputed once and applied as a
masked XOR (hard bits) or sign flip (soft LLRs) across the whole packet batch
— there is no sequential state at all.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..utils.lfsr import additive_scrambler_keystream

__all__ = ["keystream", "scramble_bits", "descramble_soft"]


@lru_cache(maxsize=8)
def _keystream_np(num_bits: int) -> np.ndarray:
    return additive_scrambler_keystream(num_bits)


@lru_cache(maxsize=8)
def _keystream_packed(num_bits: int) -> np.ndarray:
    """Keystream packed 32 bits/word (bit i of word w = keystream bit
    32w + i). Packed form keeps jit-embedded literals small."""
    n32 = -(-num_bits // 32) * 32
    bits = _keystream_np(n32)
    words = bits.reshape(-1, 32).astype(np.uint32)
    return (words << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32
    )


def keystream(num_bits: int) -> jnp.ndarray:
    """First ``num_bits`` scrambler keystream bits, expanded on device from
    the packed literal."""
    packed = _keystream_packed(int(num_bits))
    bits = (
        (jnp.asarray(packed)[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :])
        & 1
    ).reshape(-1)[:num_bits]
    return bits.astype(jnp.uint8)


def scramble_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """XOR hard bits ``[..., N]`` with the keystream (restart at index 0)."""
    ks = keystream(bits.shape[-1])
    return bits ^ ks.astype(bits.dtype)


def descramble_soft(llrs: jnp.ndarray) -> jnp.ndarray:
    """Sign-flip soft values where the keystream bit is 1
    (additive_scrambler.hpp:89-93 soft-symbol branch)."""
    ks = keystream(llrs.shape[-1])
    return jnp.where(ks.astype(bool), -llrs, llrs)
