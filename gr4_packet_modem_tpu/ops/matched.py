"""Per-detection matched filter and decimation.

The receiver's symbol extraction filters each detection's sample region with
that detection's own polyphase-arm taps and decimates by sps
(symbol_filter.hpp:208-238, vectorized over detections):

    out[d, s] = sum_k z[d, sps*s + k] * taps[d, k]

``taps`` are time-reversed (correlation form). The filter runs as K shifted
strided slices multiplied and added, which XLA fuses into one elementwise
pass. (A depthwise grouped convolution computes the same; on an H100 it ran
10x slower at the payload-pass shape, see PERF.md.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["matched_filter"]


def matched_filter(
    zr: jax.Array, zi: jax.Array, taps: jax.Array, sps: int, num_syms: int
) -> tuple[jax.Array, jax.Array]:
    """``zr``/``zi``: f32 ``[D, R]`` region planes with
    ``R >= sps*(num_syms-1) + K``; ``taps``: f32 ``[D, K]``. Returns the
    filtered I/Q planes ``[D, num_syms]``. The region is split into its
    ``sps`` phases (``[D, rows, sps]``, a free reshape), and tap
    ``k = q*sps + p`` reads phase ``p`` shifted by ``q`` symbols."""
    d, r = zr.shape
    k = taps.shape[1]
    nq = -(-k // sps)
    rows = num_syms + nq - 1
    if r < sps * (num_syms - 1) + k:
        raise ValueError("region too short for num_syms symbols")

    def one(z):
        z = z[:, : rows * sps]
        zp = jnp.pad(z, ((0, 0), (0, rows * sps - z.shape[1])))
        zp = zp.reshape(d, rows, sps)
        acc = zp[:, 0:num_syms, 0] * taps[:, 0:1]
        for j in range(1, k):
            q, p = divmod(j, sps)
            acc = acc + zp[:, q : q + num_syms, p] * taps[:, j : j + 1]
        return acc

    return one(zr), one(zi)
