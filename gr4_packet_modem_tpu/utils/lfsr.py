"""LFSR sequence generators (host-side, numpy).

The modem uses two shift-register sequences:

- the CCSDS additive scrambler (additive_scrambler.hpp:77-94): a Fibonacci
  LFSR parameterized by ``mask``/``seed``/``length`` (GR3 convention). The
  scrambler restarts at every packet (header start), so the whole
  keystream is precomputed once here and applied as a vectorized XOR /
  sign-flip.

- the degree-``n`` Galois LFSR of GlfsrSource (glfsr_source.hpp:38-89) that
  supplies the pseudo-random burst ramp-down bits. Its state persists across
  packets, so packet ``p`` consumes bits ``[18p, 18p+18)`` of the sequence; we
  precompute a long prefix and index into it.
"""

from __future__ import annotations

import numpy as np

from .constants import SCRAMBLER_LENGTH, SCRAMBLER_MASK, SCRAMBLER_SEED

__all__ = ["additive_scrambler_keystream", "glfsr_bits", "GLFSR_POLYNOMIAL_MASKS"]


def additive_scrambler_keystream(
    num_bits: int,
    mask: int = SCRAMBLER_MASK,
    seed: int = SCRAMBLER_SEED,
    length: int = SCRAMBLER_LENGTH,
) -> np.ndarray:
    """First ``num_bits`` bits of the additive scrambler keystream.

    Bit ``i`` is the LFSR output bit XORed with data bit ``i``
    (additive_scrambler.hpp:84-87): out = reg & 1; shift_in = parity(reg &
    mask); reg = (shift_in << length) | (reg >> 1).
    """
    out = np.empty(num_bits, dtype=np.uint8)
    reg = int(seed)
    for i in range(num_bits):
        out[i] = reg & 1
        shift_in = bin(reg & mask).count("1") & 1
        reg = (shift_in << length) | (reg >> 1)
    return out


# Primitive polynomial masks per degree (glfsr_source.hpp:38-71; standard
# maximal-length LFSR taps).
GLFSR_POLYNOMIAL_MASKS = np.array(
    [
        0x00000000, 0x00000001, 0x00000003, 0x00000005, 0x00000009,
        0x00000012, 0x00000021, 0x00000041, 0x0000008E, 0x00000108,
        0x00000204, 0x00000402, 0x00000829, 0x0000100D, 0x00002015,
        0x00004001, 0x00008016, 0x00010004, 0x00020013, 0x00040013,
        0x00080004, 0x00100002, 0x00200001, 0x00400010, 0x0080000D,
        0x01000004, 0x02000023, 0x04000013, 0x08000004, 0x10000002,
        0x20000029, 0x40000004, 0x80000057,
    ],
    dtype=np.uint64,
)


def glfsr_bits(num_bits: int, degree: int = 32, seed: int = 1) -> np.ndarray:
    """First ``num_bits`` output bits of the Galois LFSR source.

    Matches GlfsrSource::processOne (glfsr_source.hpp:95-103): bit = reg & 1;
    reg >>= 1; if bit: reg ^= mask.
    """
    if degree > 32:
        raise ValueError(f"degree {degree} too large")
    mask = int(GLFSR_POLYNOMIAL_MASKS[degree])
    out = np.empty(num_bits, dtype=np.uint8)
    reg = int(seed)
    for i in range(num_bits):
        bit = reg & 1
        reg >>= 1
        if bit:
            reg ^= mask
        out[i] = bit
    return out
