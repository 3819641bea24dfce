"""Decision-directed Costas carrier recovery, batched over packets.

The reference CostasLoop (costas_loop.hpp) is a per-symbol 2nd-order PLL whose
discriminant and bandwidth are switched by tags along the packet (PILOT over
the wiped-off syncword, QPSK over header and payload, bandwidths
0.02/0.01/0.005 — payload_metadata_insert.hpp:63-65). Because the schedule is
a *fixed function of symbol position* (syncword 64, header 128, payload rest),
a whole batch of packets runs as one ``lax.scan`` over symbol index with the
batch dimension vectorized: every scan step advances all packets by one
symbol. The loop gains come from the same closed-form cubic solve as the
reference (costas_loop.hpp:67-87). ``costas_run`` is the plain reference;
ops/costas_gpu.py runs the same recursion as one GPU kernel.

A feed-forward (scan-free) phase estimator is also provided for
high-throughput paths where loop-exact behavior is not required.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import constants as C

__all__ = ["costas_coefficients", "costas_segments", "costas_run", "vv_phase_estimate"]


@lru_cache(maxsize=32)
def costas_coefficients(loop_bandwidth: float, qpsk: bool) -> tuple[float, float]:
    """Closed-form K1/K2 from the loop bandwidth B_L*T
    (costas_loop.hpp:67-87). ``qpsk`` divides by the sqrt(2) discriminant
    gain."""
    bw = float(loop_bandwidth)
    bw2, bw3, bw4 = bw * bw, bw**3, bw**4
    s = np.cbrt(
        36.0 * bw2
        + np.sqrt(3.0) * np.sqrt(432.0 * bw4 + 848.0 * bw3 + 624.0 * bw2 + 204.0 * bw + 25.0)
        + 36.0 * bw
        + 9.0
    )
    z = (
        -(-12.0 * bw - 6.0) / (3.0 * np.cbrt(6.0) * (2.0 * bw + 1.0) * s)
        + (np.cbrt(2.0) * s) / (np.cbrt(9.0) * (2.0 * bw + 1.0))
        - 1.0
    )
    k1 = 1.0 - z * z
    k2 = (1.0 - z) * (1.0 - z)
    gain = np.sqrt(2.0) if qpsk else 1.0
    return float(k1 / gain), float(k2 / gain)


def costas_segments(
    num_symbols: int, offset: int = 0
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-symbol (constellation id, k1, k2) schedule for a packet starting at
    its syncword: 64 PILOT @ bw 0.02, 128 QPSK @ bw 0.01, payload QPSK
    @ bw 0.005. ``offset`` shifts the symbol index (e.g. 192 for the payload
    pass). Built from scalars with iota selects so jitted callers embed only
    a few constants instead of [S]-sized literals."""
    s = jnp.arange(num_symbols, dtype=jnp.int32) + offset
    hdr_end = C.SYNCWORD_LEN + C.HEADER_SYMBOLS
    const = jnp.where(
        s < C.SYNCWORD_LEN,
        jnp.int32(C.Constellation.PILOT),
        jnp.int32(C.Constellation.QPSK),
    )
    k1a, k2a = costas_coefficients(C.SYNCWORD_COSTAS_BW, False)
    k1b, k2b = costas_coefficients(C.HEADER_COSTAS_BW, True)
    k1c, k2c = costas_coefficients(C.PAYLOAD_COSTAS_BW, True)

    def piecewise(a, b, c):
        return jnp.where(
            s < C.SYNCWORD_LEN,
            jnp.float32(a),
            jnp.where(s < hdr_end, jnp.float32(b), jnp.float32(c)),
        )

    return const, piecewise(k1a, k1b, k1c), piecewise(k2a, k2b, k2c)


def _phase_error(z: jax.Array, const_id: jax.Array) -> jax.Array:
    """Discriminants of costas_loop.hpp:119-138, selected per packet/symbol."""
    e_pilot = z.imag
    e_bpsk = z.real * z.imag
    e_qpsk = jnp.where(z.real > 0, z.imag, -z.imag) + jnp.where(
        z.imag > 0, -z.real, z.real
    )
    return jnp.where(
        const_id == int(C.Constellation.PILOT),
        e_pilot,
        jnp.where(const_id == int(C.Constellation.BPSK), e_bpsk, e_qpsk),
    )


def costas_run(
    symbols: jax.Array,
    phase0: jax.Array,
    freq0: jax.Array,
    const_ids: jax.Array,
    k1: jax.Array,
    k2: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Run the Costas loop over a batch of packets.

    symbols: complex64 ``[B, S]``; phase0/freq0: ``[B]`` initial loop state
    (phase preset from the syncword_phase estimate, costas_loop.hpp:101-105).
    const_ids/k1/k2: ``[S]`` per-symbol schedule (shared across the batch).
    Returns ``(corrected [B, S], phase_end [B], freq_end [B])``.
    """
    # the scan carries/threads only real arrays: z = x * e^{-i phase} is done
    # on I/Q planes explicitly
    sym_re = jnp.moveaxis(symbols.real, -1, 0)  # [S, B]
    sym_im = jnp.moveaxis(symbols.imag, -1, 0)

    def step(carry, xs):
        phase, freq = carry
        xr, xi, cid, g1, g2 = xs
        c, s = jnp.cos(phase), jnp.sin(phase)
        zr = xr * c + xi * s
        zi = xi * c - xr * s
        e_pilot = zi
        e_bpsk = zr * zi
        e_qpsk = jnp.where(zr > 0, zi, -zi) + jnp.where(zi > 0, -zr, zr)
        e = jnp.where(
            cid == int(C.Constellation.PILOT),
            e_pilot,
            jnp.where(cid == int(C.Constellation.BPSK), e_bpsk, e_qpsk),
        )
        freq = freq + g2 * e
        phase = phase + g1 * e + freq
        phase = jnp.where(phase >= np.pi, phase - 2 * np.float32(np.pi), phase)
        phase = jnp.where(phase < -np.pi, phase + 2 * np.float32(np.pi), phase)
        return (phase, freq), (zr, zi)

    (phase_end, freq_end), (out_re, out_im) = jax.lax.scan(
        step,
        (phase0.astype(jnp.float32), freq0.astype(jnp.float32)),
        (sym_re, sym_im, const_ids, k1, k2),
    )
    out = jax.lax.complex(
        jnp.moveaxis(out_re, 0, -1), jnp.moveaxis(out_im, 0, -1)
    )
    return out, phase_end, freq_end


def vv_phase_estimate(
    symbols: jax.Array, block: int = 32
) -> jax.Array:
    """Feed-forward Viterbi&Viterbi 4th-power phase estimate per symbol
    (QPSK), block-averaged and unwrapped — the scan-free alternative for
    throughput-critical paths (within-SNR equivalent, not loop-exact)."""
    z4 = symbols**4
    s = symbols.shape[-1]
    nb = s // block
    zb = z4[..., : nb * block].reshape(*symbols.shape[:-1], nb, block).mean(-1)
    ph4 = jnp.angle(zb)
    ph4 = jnp.concatenate(
        [ph4[..., :1], ph4[..., :1] * 0 + jnp.diff(ph4, axis=-1)], axis=-1
    )
    ph4 = jnp.where(ph4 > np.pi, ph4 - 2 * np.pi, ph4)
    ph4 = jnp.where(ph4 < -np.pi, ph4 + 2 * np.pi, ph4)
    ph4 = jnp.cumsum(ph4, axis=-1)
    phase = ph4 / 4.0 - np.pi / 4.0
    up = jnp.repeat(phase, block, axis=-1)
    pad = s - up.shape[-1]
    if pad:
        up = jnp.concatenate([up, jnp.repeat(up[..., -1:], pad, axis=-1)], axis=-1)
    return up
