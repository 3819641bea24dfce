"""Costas carrier-recovery loop as one Pallas kernel for the GPU (Triton).

The Costas loop (costas_loop.hpp:113-146) is a per-symbol nonlinear IIR, so it
cannot be parallelised along time. As a ``lax.scan`` (ops/costas.py) every
symbol is one iteration of an XLA while loop, i.e. at least one kernel launch
per symbol. This kernel runs the identical recursion with the loop over
symbols inside the kernel:

- one detection row per thread; the loop state (phase, frequency) stays in
  registers for the whole packet;
- symbols are laid out ``[S, B]`` (time-major, as ``costas_run`` transposes
  them), so each step's loads and stores are coalesced across the rows of a
  block;
- the positional (K1, K2) schedule (PILOT over the wiped-off syncword, QPSK
  at header bandwidth, QPSK at payload bandwidth —
  payload_metadata_insert.hpp:63-65) is baked in at compile time from the
  static symbol offset;
- the symbol loop is unrolled by ``_UNROLL`` and software-pipelined: the next
  chunk's symbols are loaded before the current chunk is tracked, so the
  memory latency overlaps the serial trig/update chain.

The grid is one program (one warp) per ``BLOCK_ROWS`` detection rows. The kernel runs
through Pallas' Triton route; ``interpret=True`` runs it in the Pallas
interpreter on any backend (the CPU tests).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils import constants as C
from .costas import costas_coefficients, costas_run, costas_segments

__all__ = ["costas_track", "costas_track_gpu", "BLOCK_ROWS"]

_HDR_END = C.SYNCWORD_LEN + C.HEADER_SYMBOLS  # 192
_PI = np.float32(np.pi)
_TWO_PI = np.float32(2 * np.pi)

# detection rows per program: one warp, one row per thread
BLOCK_ROWS = 32
# symbols per pipelined chunk (loads of chunk k+1 overlap tracking of chunk k)
_UNROLL = 8


def _make_kernel(num_syms: int, offset: int, s_pad: int):
    k1a, k2a = costas_coefficients(C.SYNCWORD_COSTAS_BW, False)
    k1b, k2b = costas_coefficients(C.HEADER_COSTAS_BW, True)
    k1c, k2c = costas_coefficients(C.PAYLOAD_COSTAS_BW, True)
    nchunks = s_pad // _UNROLL

    def gain(g, a, b, c):
        return jnp.where(
            g < C.SYNCWORD_LEN,
            jnp.float32(a),
            jnp.where(g < _HDR_END, jnp.float32(b), jnp.float32(c)),
        )

    def kernel(ph0_ref, fr0_ref, re_ref, im_ref, out_re_ref, out_im_ref,
               ph_end_ref, fr_end_ref):
        def load_chunk(k):
            # clamp: the prefetch past the last chunk reads (and discards)
            # the final row instead of running off the block
            base = jnp.minimum(k, nchunks - 1) * _UNROLL
            xr = tuple(re_ref[base + u, :] for u in range(_UNROLL))
            xi = tuple(im_ref[base + u, :] for u in range(_UNROLL))
            return xr, xi

        def body(k, carry):
            ph, fr, xr, xi = carry
            nxt = load_chunk(k + 1)
            for u in range(_UNROLL):
                s = k * _UNROLL + u
                g = s + offset  # symbol index within the packet
                c = jnp.cos(ph)
                sn = jnp.sin(ph)
                zr = xr[u] * c + xi[u] * sn
                zi = xi[u] * c - xr[u] * sn
                e_qpsk = jnp.where(zr > 0, zi, -zi) + jnp.where(zi > 0, -zr, zr)
                e = jnp.where(g < C.SYNCWORD_LEN, zi, e_qpsk)
                fr_n = fr + gain(g, k2a, k2b, k2c) * e
                ph_n = ph + gain(g, k1a, k1b, k1c) * e + fr_n
                ph_n = jnp.where(ph_n >= _PI, ph_n - _TWO_PI, ph_n)
                ph_n = jnp.where(ph_n < -_PI, ph_n + _TWO_PI, ph_n)
                # padding symbols past num_syms leave the state untouched
                live = s < num_syms
                ph = jnp.where(live, ph_n, ph)
                fr = jnp.where(live, fr_n, fr)
                out_re_ref[s, :] = zr
                out_im_ref[s, :] = zi
            return ph, fr, *nxt

        ph, fr, _, _ = jax.lax.fori_loop(
            0, nchunks, body, (ph0_ref[:], fr0_ref[:], *load_chunk(0))
        )
        ph_end_ref[:] = ph
        fr_end_ref[:] = fr

    return kernel


@partial(jax.jit, static_argnames=("offset", "interpret"))
def costas_track_gpu(
    symbols: jax.Array,
    phase0: jax.Array,
    freq0: jax.Array,
    offset: int = 0,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Loop-exact Costas tracking of ``symbols [B, S]`` complex64 starting at
    packet symbol ``offset``. Returns ``(corrected [B, S], phase_end [B],
    freq_end [B])``, the contract of ``costas_run`` with the receiver's
    positional schedule. Any B (padded to ``BLOCK_ROWS``) and any S (padded
    to the unroll factor; padded steps do not advance the loop)."""
    b, s = symbols.shape
    b_pad = -(-b // BLOCK_ROWS) * BLOCK_ROWS
    s_pad = max(-(-s // _UNROLL), 1) * _UNROLL

    def plane(a):  # [B, S] -> zero-padded time-major [S_pad, B_pad]
        return jnp.pad(a.T, ((0, s_pad - s), (0, b_pad - b)))

    def state(a):
        return jnp.pad(a.astype(jnp.float32), (0, b_pad - b))

    row_spec = pl.BlockSpec((BLOCK_ROWS,), lambda i: (i,))
    plane_spec = pl.BlockSpec((s_pad, BLOCK_ROWS), lambda i: (0, i))
    out_re, out_im, ph_end, fr_end = pl.pallas_call(
        _make_kernel(s, offset, s_pad),
        grid=(b_pad // BLOCK_ROWS,),
        in_specs=[row_spec, row_spec, plane_spec, plane_spec],
        out_specs=(plane_spec, plane_spec, row_spec, row_spec),
        out_shape=(
            jax.ShapeDtypeStruct((s_pad, b_pad), jnp.float32),
            jax.ShapeDtypeStruct((s_pad, b_pad), jnp.float32),
            jax.ShapeDtypeStruct((b_pad,), jnp.float32),
            jax.ShapeDtypeStruct((b_pad,), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="costas_track",
    )(state(phase0), state(freq0), plane(symbols.real), plane(symbols.imag))
    corrected = jax.lax.complex(out_re[:s, :b].T, out_im[:s, :b].T)
    return corrected, ph_end[:b], fr_end[:b]


def costas_track(
    symbols: jax.Array,
    phase0: jax.Array,
    freq0: jax.Array,
    offset: int = 0,
    use_pallas: bool | None = None,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """The receiver's Costas tracking, with the implementation chosen per
    platform. This is the one place that choice is made:

    - ``use_pallas=None``: the kernel when the program is compiled for a
      CUDA GPU, ``costas_run``'s scan on every other platform. The choice is
      staged with ``lax.platform_dependent``, so it follows the device the
      program is compiled for, not the process's default backend;
    - ``use_pallas=True``: the kernel; a platform without one raises (it
      never falls back to the interpreter);
    - ``use_pallas=False``: the scan;
    - ``interpret=True`` (with ``use_pallas`` not False): the kernel in the
      Pallas interpreter, on any platform (tests).
    """

    def scan(sym, ph, fr):
        const_ids, k1, k2 = costas_segments(sym.shape[-1], offset=offset)
        return costas_run(sym, ph, fr, const_ids, k1, k2)

    def kernel(sym, ph, fr):
        return costas_track_gpu(sym, ph, fr, offset=offset, interpret=interpret)

    if use_pallas is False:
        return scan(symbols, phase0, freq0)
    if interpret:
        return kernel(symbols, phase0, freq0)
    if use_pallas:
        if jax.default_backend() != "gpu":
            raise NotImplementedError(
                "use_pallas=True: the Costas kernel exists only for CUDA "
                f"GPUs, not {jax.default_backend()!r}; use use_pallas=None, "
                "or interpret=True to run it in the Pallas interpreter"
            )
        # no default branch: lowering for another platform fails
        return jax.lax.platform_dependent(
            symbols, phase0, freq0, cuda=kernel
        )
    return jax.lax.platform_dependent(
        symbols, phase0, freq0, cuda=kernel, default=scan
    )
