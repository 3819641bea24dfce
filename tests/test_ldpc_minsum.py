"""Header LDPC decoder (ops/ldpc.py) against a plain numpy normalized
min-sum flooding decoder over the same parity-check matrix."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gr4_packet_modem_tpu.ops import ldpc


def _numpy_minsum(llr, h, iters=25, alpha=0.75):
    """Edge-by-edge normalized min-sum (flooding), float32."""
    llr = llr.astype(np.float32)
    b = llr.shape[0]
    checks = [np.nonzero(row)[0] for row in h]
    c2v = [np.zeros((b, len(vs)), np.float32) for vs in checks]

    def totals():
        t = llr.copy()
        for vs, msg in zip(checks, c2v):
            for j, v in enumerate(vs):
                t[:, v] += msg[:, j]
        return t

    for _ in range(iters):
        t = totals()
        new = []
        for vs, msg in zip(checks, c2v):
            v2c = t[:, vs] - msg
            out = np.empty_like(v2c)
            for j in range(len(vs)):
                others = np.delete(v2c, j, axis=1)
                sign = np.prod(np.where(others >= 0, 1.0, -1.0), axis=1)
                out[:, j] = alpha * sign * np.min(np.abs(others), axis=1)
            new.append(out.astype(np.float32))
        c2v = new
    hard = (totals() < 0).astype(np.uint8)
    ok = ((hard.astype(np.int64) @ h.T) % 2 == 0).all(axis=1)
    return hard[:, :32], ok


def _noisy_llrs(b, snr_db, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (b, 32), dtype=np.uint8)
    cw = np.asarray(ldpc.encode_header(jnp.asarray(bits)))[:, :128]
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10)))
    bpsk = 1.0 - 2.0 * cw.astype(np.float32)
    llr = (2.0 / sigma**2) * (
        bpsk + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    )
    return llr.astype(np.float32)


@pytest.mark.parametrize(
    "snr_db,precision",
    [
        (-2.0, "default"),
        (-2.0, "highest"),
        (0.0, "tensorfloat32"),
        (3.0, "default"),
    ],
)
def test_decoder_matches_numpy_minsum(snr_db, precision):
    """Decoded bits and parity flags equal the reference's, whatever the
    matmul precision (the decoder's only dots multiply 0/1 values)."""
    llr = _noisy_llrs(48, snr_db, seed=int(20 + snr_db))
    ref_bits, ref_ok = _numpy_minsum(llr, ldpc.load_parity_check())
    with jax.default_matmul_precision(precision):
        bits, ok = ldpc.HeaderLdpcDecoder(25).decode(jnp.asarray(llr))
    np.testing.assert_array_equal(np.asarray(bits), ref_bits)
    np.testing.assert_array_equal(np.asarray(ok), ref_ok)


def test_failure_regime_matches_numpy_minsum():
    """At low SNR some codewords fail to converge; the flags still agree."""
    llr = _noisy_llrs(64, -6.0, seed=4)
    ref_bits, ref_ok = _numpy_minsum(llr, ldpc.load_parity_check())
    assert 0.0 < ref_ok.mean() < 1.0
    bits, ok = ldpc.HeaderLdpcDecoder(25).decode(jnp.asarray(llr))
    np.testing.assert_array_equal(np.asarray(ok), ref_ok)
    np.testing.assert_array_equal(np.asarray(bits)[ref_ok], ref_bits[ref_ok])


def test_unrolled_decoder_identical():
    llr = jnp.asarray(_noisy_llrs(40, -1.0, seed=9))
    a = ldpc.HeaderLdpcDecoder(25, unroll=1).decode(llr)
    b = ldpc.HeaderLdpcDecoder(25, unroll=True).decode(llr)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
