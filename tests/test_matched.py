"""Matched filter + decimation (ops/matched.py) and the batched region slice
(utils/cplx.slice_windows) against numpy, and the receiver's chunked symbol
extraction against its one-chunk form."""

import numpy as np
import pytest

import jax.numpy as jnp

from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig
from gr4_packet_modem_tpu.ops.matched import matched_filter
from gr4_packet_modem_tpu.utils.cplx import slice_windows


def _einsum_ref(zr, zi, taps, sps, num_syms):
    """out[d, s] = sum_k z[d, sps*s + k] * taps[d, k] via a window view."""
    k = taps.shape[1]
    ref = []
    for z in (zr, zi):
        win = np.lib.stride_tricks.sliding_window_view(z, k, axis=1)
        ref.append(np.einsum("dsk,dk->ds", win[:, ::sps][:, :num_syms], taps))
    return ref


@pytest.mark.parametrize(
    "d,k,sps,num_syms",
    [
        (5, 44, 4, 50),     # the receiver's 44-tap arms at sps 4
        (12, 44, 4, 192),   # header pass length
        (3, 33, 2, 17),     # odd tap count, sps 2
        (7, 24, 8, 9),      # taps an exact sps multiple
        (4, 44, 4, 1),      # a single symbol
    ],
)
def test_matched_filter_matches_einsum(d, k, sps, num_syms):
    rng = np.random.default_rng(d * k + sps)
    r = sps * (num_syms - 1) + k + 3  # a few spare samples past the end
    zr, zi = (rng.standard_normal((d, r)).astype(np.float32) for _ in range(2))
    taps = rng.standard_normal((d, k)).astype(np.float32)
    out = matched_filter(jnp.asarray(zr), jnp.asarray(zi), jnp.asarray(taps),
                         sps, num_syms)
    for o, ref in zip(out, _einsum_ref(zr, zi, taps, sps, num_syms)):
        assert o.shape == (d, num_syms)
        np.testing.assert_allclose(np.asarray(o), ref, rtol=1e-5, atol=1e-4)


def test_slice_windows_matches_numpy():
    rng = np.random.default_rng(0)
    t, d, size = 5000, 16, 809
    a = rng.standard_normal(t).astype(np.float32)
    starts = rng.integers(0, t - size, d).astype(np.int32)
    out = slice_windows(jnp.asarray(a), jnp.asarray(starts), size)
    np.testing.assert_array_equal(
        np.asarray(out), np.stack([a[s : s + size] for s in starts])
    )


def test_slice_windows_clamps_at_end():
    """Starts past len-size clamp, so windows never read past the end (the
    receiver clips its starts into range first; both edges are exact)."""
    a = np.arange(100, dtype=np.float32)
    starts = np.array([0, 90, 95, 99, 200], np.int32)
    out = np.asarray(slice_windows(jnp.asarray(a), jnp.asarray(starts), 10))
    clamped = np.minimum(starts, 90)
    np.testing.assert_array_equal(out, np.stack([a[s : s + 10] for s in clamped]))


def test_extraction_chunked_matches_one_chunk():
    """Extractions longer than 4 x symbol_chunk run as a lax.map over chunks;
    the result equals the one-chunk extraction."""
    rng = np.random.default_rng(3)
    n = 30000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    d, num_syms = 3, 1100
    n_base = jnp.asarray([600, 900, 1234], jnp.int32)
    arm = jnp.asarray([0, 13, 31], jnp.int32)
    freq = jnp.asarray([0.001, -0.004, 0.0], jnp.float32)
    n0 = jnp.asarray([550, 870, 1200], jnp.int32)
    amp = jnp.ones(d, jnp.float32)

    def extract(chunk):
        rx = Receiver(RxConfig(max_payload_len=64, symbol_chunk=chunk))
        return np.asarray(rx._extract_symbols(
            jnp.asarray(x), n_base, arm, freq, n0, amp, 0, num_syms
        ))

    one, chunked = extract(2048), extract(256)  # 1100 > 4*256: 5 chunks
    assert one.shape == chunked.shape == (d, num_syms)
    np.testing.assert_allclose(chunked, one, rtol=1e-5, atol=1e-5)
