"""Polyphase FIR kernels.

Batched re-design of the reference's per-item FIR loops:

- ``interpolating_fir``: the TX pulse shaper (interpolating_fir_filter.hpp):
  instead of a per-sample history buffer, each output polyphase branch is a
  small matmul between a window-stack of the symbol sequence and the branch
  taps, batched over packets/bursts.
- ``pfb_symbol_filter``: the RX matched filter + decimator
  (symbol_filter.hpp): a packet's symbols are one strided window gather dotted
  with the packet's polyphase arm taps (the arm is fixed per packet, selected
  by the acquisition time estimate).
- ``pfb_arb_resample``: the channel-model arbitrary resampler
  (pfb_arb_resampler.hpp): output sample times are known in closed form, so
  arms, fractional interpolation weights and input windows are all computed
  in parallel instead of with a phase-accumulator loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "interpolating_fir",
    "stream_interpolating_fir",
    "pfb_symbol_filter",
    "pfb_arb_resample",
]


def _window_stack(x: jax.Array, k: int) -> jax.Array:
    """Stack of causal windows: w[..., s, j] = x[..., s - j] (zero before
    start), j = 0..k-1 (newest first). Shape [..., S, k]."""
    pad = [(0, 0)] * (x.ndim - 1) + [(k - 1, 0)]
    xp = jnp.pad(x, pad)
    cols = [
        jax.lax.slice_in_dim(xp, k - 1 - j, k - 1 - j + x.shape[-1], axis=-1)
        for j in range(k)
    ]
    return jnp.stack(cols, axis=-1)


def interpolating_fir(symbols: jax.Array, taps: np.ndarray, interpolation: int) -> jax.Array:
    """Interpolating FIR: ``[..., S]`` symbols -> ``[..., S*I]`` samples.

    Polyphase branch j of output symbol s is
    ``sum_k taps[j + I*k] * x[s - k]`` (interpolating_fir_filter.hpp:90-99),
    with zero initial history (each burst starts from a flushed filter).
    """
    i = int(interpolation)
    taps = np.asarray(taps, dtype=np.float32)
    arm_len = -(-taps.size // i)
    tp = np.zeros((i, arm_len), dtype=np.float32)
    for j in range(i):
        arm = taps[j::i]
        tp[j, : arm.size] = arm
    tpj = jnp.asarray(tp.T)  # [K, I]
    w = _window_stack(symbols, arm_len)  # [..., S, K]
    # full f32 precision: a default-precision f32 einsum may run in TF32 on
    # the GPU (about 3 decimal digits)
    fir = lambda a: jnp.einsum(
        "...sk,ki->...si", a, tpj, precision=jax.lax.Precision.HIGHEST
    )
    if jnp.iscomplexobj(symbols):
        y = (fir(w.real) + 1j * fir(w.imag)).astype(symbols.dtype)
    else:
        y = fir(w)
    return y.reshape(*symbols.shape[:-1], symbols.shape[-1] * i)


def stream_interpolating_fir(
    carry: jax.Array, symbols: jax.Array, taps: np.ndarray, interpolation: int
) -> tuple[jax.Array, jax.Array]:
    """Streaming variant with carried history.

    ``carry`` holds the previous ``K-1`` symbols (zeros initially). Returns
    ``(new_carry, samples)`` where samples has length ``len(symbols) * I``.
    """
    i = int(interpolation)
    taps = np.asarray(taps, dtype=np.float32)
    arm_len = -(-taps.size // i)
    x = jnp.concatenate([carry, symbols], axis=-1)
    y = interpolating_fir(x, taps, i)[..., (arm_len - 1) * i :]
    new_carry = x[..., -(arm_len - 1) :]
    return new_carry, y


def pfb_symbol_filter(
    samples: jax.Array,
    start: jax.Array,
    arm: jax.Array,
    pfb_taps: np.ndarray | jax.Array,
    num_arms: int,
    num_symbols: int,
    sps: int = 4,
) -> jax.Array:
    """Matched-filter and decimate one packet to 1 sample/symbol.

    ``samples``: the full (freq-corrected) complex sample buffer ``[N]``.
    ``start``: index of the sample at which symbol 0 is output (i.e. the
    newest history sample for the first inner product — acquisition start +
    filter delay, symbol_filter.hpp:208-238).
    ``arm``: polyphase arm index selected from the fractional time estimate.
    Output symbol s = sum_k taps[arm + A*k] * samples[start + sps*s - k].
    """
    pfb_taps = jnp.asarray(pfb_taps)
    arm_len = pfb_taps.shape[0] // num_arms
    arm_taps = pfb_taps[arm + num_arms * jnp.arange(arm_len)]  # [K]
    k = arm_len
    from ..utils.cplx import cdynslice

    base = start - (k - 1)
    region_len = sps * (num_symbols - 1) + k
    xa = cdynslice(samples, base, region_len)
    # window w[s, j] = xa[(k-1) + sps*s - j]
    cols = [
        jax.lax.slice_in_dim(xa, k - 1 - j, k - 1 - j + sps * (num_symbols - 1) + 1)[
            ::sps
        ]
        for j in range(k)
    ]
    w = jnp.stack(cols, axis=-1)  # [S, K]
    arm_taps = arm_taps.astype(jnp.float32)
    dot = lambda a: jnp.dot(a, arm_taps, precision=jax.lax.Precision.HIGHEST)
    if jnp.iscomplexobj(w):
        return (dot(w.real) + 1j * dot(w.imag)).astype(samples.dtype)
    return dot(w)


def pfb_arb_resample(
    x: jax.Array,
    rate: float,
    taps: np.ndarray,
    diff_taps: np.ndarray,
    num_arms: int,
    num_out: int,
) -> jax.Array:
    """Polyphase arbitrary resampler with derivative-filter linear
    interpolation (pfb_arb_resampler.hpp:44-101), used as the channel-model
    sampling-frequency-offset impairment.

    Output k corresponds to input time ``t_k = k / rate``; with
    ``ip = floor(t_k)`` and fractional arm position ``fa = (t_k - ip) * A``:
    ``y[k] = dot(taps[arm], win(ip)) + frac * dot(diff_taps[arm], win(ip))``
    where ``arm = floor(fa)`` and ``frac = fa - arm``.
    """
    a = int(num_arms)
    taps = np.asarray(taps, dtype=np.float32)
    arm_len = -(-taps.size // a)

    def poly(t):
        out = np.zeros((a, arm_len), dtype=np.float32)
        for j in range(a):
            armt = t[j::a]
            out[j, : armt.size] = armt
        return jnp.asarray(out)

    tp, dtp = poly(taps), poly(np.asarray(diff_taps, dtype=np.float32))
    k = jnp.arange(num_out)
    # exact rational time base in f64-free arithmetic: split integer/frac
    step = 1.0 / float(rate)
    t = k.astype(jnp.float64) * step if jax.config.jax_enable_x64 else None
    if t is None:
        # double-single decomposition to keep fractional part accurate
        step32 = np.float32(step)
        resid = np.float32(step - float(step32))
        ti = jnp.floor(k.astype(jnp.float32) * step32)
        tf = k.astype(jnp.float32) * step32 - ti + k.astype(jnp.float32) * resid
        ip = ti.astype(jnp.int32) + jnp.floor(tf).astype(jnp.int32)
        frac_t = tf - jnp.floor(tf)
    else:
        ip = jnp.floor(t).astype(jnp.int32)
        frac_t = (t - jnp.floor(t)).astype(jnp.float32)
    fa = frac_t * a
    arm = jnp.clip(jnp.floor(fa).astype(jnp.int32), 0, a - 1)
    frac = fa - arm.astype(jnp.float32)
    from ..utils.cplx import cgather

    w = _window_stack(x, arm_len)  # [N, K] windows of input
    win = cgather(w, ip)  # [num_out, K]
    t_arm = tp[arm]  # [num_out, K]
    d_arm = dtp[arm]
    if jnp.iscomplexobj(x):
        y0 = jnp.sum(win.real * t_arm, -1) + 1j * jnp.sum(win.imag * t_arm, -1)
        y1 = jnp.sum(win.real * d_arm, -1) + 1j * jnp.sum(win.imag * d_arm, -1)
    else:
        y0 = jnp.sum(win * t_arm, -1)
        y1 = jnp.sum(win * d_arm, -1)
    return (y0 + frac.astype(jnp.float32) * y1).astype(x.dtype)
