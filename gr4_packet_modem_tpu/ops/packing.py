"""Vectorized bit packing/unpacking and constellation mapping.

Vectorized equivalents of the reference's per-item loops in PackBits / UnpackBits
(pack_bits.hpp, unpack_bits.hpp), Mapper (mapper.hpp) and BinarySlicer
(binary_slicer.hpp): pure reshapes, shifts and gathers over packet batches.
Only the MSB-first single-bit nibble cases used by the modem chains are
specialized here; ``pack_bits``/``unpack_bits`` keep the generic
``bits_per_input`` parameterization of the reference blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "unpack_bits",
    "pack_bits",
    "bytes_to_bits",
    "bits_to_bytes",
    "map_symbols",
    "binary_slice",
]


def unpack_bits(
    data: jax.Array,
    outputs_per_input: int,
    bits_per_output: int = 1,
    msb_first: bool = True,
) -> jax.Array:
    """Split each item into ``outputs_per_input`` nibbles of
    ``bits_per_output`` bits along a new trailing dimension folded into the
    last axis (unpack_bits.hpp semantics)."""
    data = data.astype(jnp.uint32)
    k = outputs_per_input
    shifts = jnp.arange(k, dtype=jnp.uint32) * bits_per_output
    if msb_first:
        shifts = shifts[::-1]
    mask = jnp.uint32((1 << bits_per_output) - 1)
    out = (data[..., None] >> shifts) & mask
    return out.reshape(*data.shape[:-1], data.shape[-1] * k).astype(jnp.uint8)


def pack_bits(
    data: jax.Array,
    inputs_per_output: int,
    bits_per_input: int = 1,
    msb_first: bool = True,
) -> jax.Array:
    """Concatenate ``inputs_per_output`` consecutive nibbles of
    ``bits_per_input`` bits into one item (pack_bits.hpp semantics)."""
    k = inputs_per_output
    mask = jnp.uint32((1 << bits_per_input) - 1)
    d = (data.astype(jnp.uint32) & mask).reshape(
        *data.shape[:-1], data.shape[-1] // k, k
    )
    shifts = jnp.arange(k, dtype=jnp.uint32) * bits_per_input
    if msb_first:
        shifts = shifts[::-1]
    return jnp.sum(d << shifts, axis=-1).astype(jnp.uint32)


def bytes_to_bits(data: jax.Array) -> jax.Array:
    """uint8 bytes -> MSB-first bits (1 bit per uint8 output item)."""
    return unpack_bits(data, 8)


def bits_to_bytes(bits: jax.Array) -> jax.Array:
    """MSB-first bits -> packed uint8 bytes."""
    return pack_bits(bits, 8).astype(jnp.uint8)


def map_symbols(indices: jax.Array, constellation: jax.Array) -> jax.Array:
    """Constellation LUT mapping (mapper.hpp): index -> complex point.

    Gathers the I/Q planes separately (utils.cplx.ctake)."""
    from ..utils.cplx import ctake

    return ctake(constellation, indices.astype(jnp.int32), axis=0)


def binary_slice(llrs: jax.Array, invert: bool = True) -> jax.Array:
    """Hard-decide soft values (binary_slicer.hpp). ``invert=True`` maps a
    positive LLR to bit 0 (the modem's LLR convention)."""
    if invert:
        return (llrs < 0).astype(jnp.uint8)
    return (llrs > 0).astype(jnp.uint8)
