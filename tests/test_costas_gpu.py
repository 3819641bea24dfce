"""Costas GPU kernel (ops/costas_gpu.py) vs the lax.scan reference.

The kernel must reproduce the scan recursion (same discriminants, gains and
wrap logic — costas_loop.hpp:113-146) including the positional
PILOT/QPSK-header/QPSK-payload schedule, the final loop state, row padding
to the block and symbol padding to the unroll factor. The kernel runs in the
Pallas interpreter here; the per-platform choice is checked on the lowered
programs (a CUDA lowering needs no GPU).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gr4_packet_modem_tpu.ops.costas import costas_run, costas_segments
from gr4_packet_modem_tpu.ops.costas_gpu import (
    BLOCK_ROWS,
    costas_track,
    costas_track_gpu,
)


def _ref(syms, ph0, fr0, offset):
    cid, k1, k2 = costas_segments(syms.shape[-1], offset=offset)
    return costas_run(syms, ph0, fr0, cid, k1, k2)


def _inputs(b, s, seed, fr_scale=0.01):
    rng = np.random.default_rng(seed)
    syms = (
        rng.standard_normal((b, s)) + 1j * rng.standard_normal((b, s))
    ).astype(np.complex64)
    ph0 = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    fr0 = rng.uniform(-fr_scale, fr_scale, b).astype(np.float32)
    return jnp.asarray(syms), jnp.asarray(ph0), jnp.asarray(fr0)


def _assert_close(out, ref):
    for a, r in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize(
    "b,s,offset",
    [
        (32, 192, 0),     # header pass shape, one full block
        (5, 300, 192),    # rows not a block multiple, payload continuation
        (70, 191, 0),     # three blocks, S not an unroll multiple
        (33, 1, 0),       # a single symbol
        (3, 1, 192),      # a single payload symbol
        (40, 192, 192),   # payload-bandwidth segment only
        (BLOCK_ROWS + 1, 65, 0),  # pilot/header boundary inside a chunk
        (16, 6160, 192),  # full 1536-byte payload pass
    ],
)
def test_kernel_matches_scan(b, s, offset):
    syms, ph0, fr0 = _inputs(b, s, seed=b + s + offset)
    out = costas_track_gpu(syms, ph0, fr0, offset=offset, interpret=True)
    assert out[0].shape == (b, s)
    _assert_close(out, _ref(syms, ph0, fr0, offset))


def test_kernel_phase_wrap():
    """A large frequency drives the phase through many wraps; the kernel
    keeps it in [-pi, pi) exactly as the scan does."""
    syms, ph0, fr0 = _inputs(24, 500, seed=11, fr_scale=0.5)
    ph0 = jnp.full_like(ph0, np.float32(np.pi) - 1e-3)
    out = costas_track_gpu(syms, ph0, fr0, offset=0, interpret=True)
    ref = _ref(syms, ph0, fr0, 0)
    _assert_close(out, ref)
    ph = np.asarray(out[1])
    assert np.all(ph >= -np.pi) and np.all(ph < np.pi)


@pytest.mark.parametrize("b", [BLOCK_ROWS - 1, 2 * BLOCK_ROWS])
def test_kernel_row_padding(b):
    """One row short of a block, and exactly two blocks."""
    syms, ph0, fr0 = _inputs(b, 97, seed=b)
    out = costas_track_gpu(syms, ph0, fr0, offset=0, interpret=True)
    _assert_close(out, _ref(syms, ph0, fr0, 0))


def test_kernel_vmap_batching():
    """The kernel under jax.vmap over channels."""
    rng = np.random.default_rng(7)
    syms = (
        rng.standard_normal((3, 8, 192)) + 1j * rng.standard_normal((3, 8, 192))
    ).astype(np.complex64)
    ph0 = rng.uniform(-1, 1, (3, 8)).astype(np.float32)
    fr0 = np.zeros((3, 8), np.float32)
    args = (jnp.asarray(syms), jnp.asarray(ph0), jnp.asarray(fr0))
    out = jax.vmap(
        lambda s, p, q: costas_track_gpu(s, p, q, offset=0, interpret=True)
    )(*args)
    ref = jax.vmap(lambda s, p, q: _ref(s, p, q, 0))(*args)
    _assert_close(out, ref)


def _lowered_text(use_pallas, platform):
    f = jax.jit(
        lambda s, p, q: costas_track(s, p, q, offset=0, use_pallas=use_pallas)
    )
    args = (
        jax.ShapeDtypeStruct((64, 192), jnp.complex64),
        jax.ShapeDtypeStruct((64,), jnp.float32),
        jax.ShapeDtypeStruct((64,), jnp.float32),
    )
    return f.trace(*args).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize(
    "use_pallas,platform,kernel",
    [
        (None, "cuda", True),   # auto: the kernel on the GPU
        (None, "cpu", False),   # auto: the scan elsewhere
        (False, "cuda", False),  # forced scan on the GPU
    ],
)
def test_kernel_choice_per_platform(use_pallas, platform, kernel):
    text = _lowered_text(use_pallas, platform)
    assert ("xla.gpu.triton" in text) == kernel
    assert ("stablehlo.while" in text) == (not kernel)


def test_forced_kernel_raises_without_gpu():
    """use_pallas=True never falls back to the interpreter."""
    syms, ph0, fr0 = _inputs(4, 16, seed=3)
    with pytest.raises(NotImplementedError, match="only for CUDA"):
        costas_track(syms, ph0, fr0, use_pallas=True)


def test_auto_runs_scan_on_cpu():
    syms, ph0, fr0 = _inputs(6, 40, seed=5)
    out = jax.jit(lambda s, p, q: costas_track(s, p, q, offset=0))(
        syms, ph0, fr0
    )
    ref = _ref(syms, ph0, fr0, 0)
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))


@pytest.mark.gpu
def test_kernel_compiled_on_gpu():
    """The compiled kernel against the scan on the card, at the bench's
    header and payload widths (the same check as chip_smoke.py phase g)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; chip_smoke.py phase g runs this check")
    import chip_smoke

    out = chip_smoke.phase_kernels(((384, 192, 0), (384, 6160, 192)), iters=1)
    assert [o["hard_decision_flips"] for o in out] == [0, 0]
