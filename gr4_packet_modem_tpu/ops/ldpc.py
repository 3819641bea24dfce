"""Header LDPC (128,32) code: batched encoder and belief-propagation decoder.

The air interface protects the 32-bit header with a systematic (128,32) LDPC
code followed by a x2 repetition (total rate 1/8). The generator is the dense
96x32 GF(2) matrix embedded in the reference encoder
(header_fec_encoder.hpp:29-46); the parity-check matrix is the alist embedded
in the reference decoder (header_fec_decoder.hpp:31-260). Both are shipped as
data files under ``gr4_packet_modem_tpu/data`` and verified against each other
(H @ G = 0) in the tests.

Design: encoding is a tiny GF(2) matmul batched over packets. Decoding is a
batched normalized-min-sum belief-propagation decoder with a flooding
schedule: the 96 checks (degrees 3-5) are stored as a dense padded ``[96, 5]``
edge table, so one iteration is an edge gather, a masked two-min
sign/magnitude reduction and a per-variable sum over a fixed
variable-to-edge table (a second gather, so the summation order is fixed and
the result deterministic) — all vectorized over the codeword batch. (The
reference calls into the Rust ldpc-toolbox serial C FFI decoder instead,
algorithm "HLAminstari8" with 25 iterations.)
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import constants as C

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")

__all__ = [
    "load_generator",
    "load_parity_check",
    "encode_header",
    "HeaderLdpcDecoder",
    "make_header_decoder",
]


@lru_cache(maxsize=1)
def load_generator() -> np.ndarray:
    """Codeword-from-info GF(2) matrix ``[128, 32]``.

    Codeword = [info(32) | parity(96)]; parity r = parity(info & gen[r]) with
    the u32 rows applied MSB-first (header_fec_encoder.hpp:97-111).
    """
    gen = np.load(os.path.join(_DATA_DIR, "header_ldpc_generator.npy"))
    g = np.zeros((C.HEADER_LDPC_N, C.HEADER_LDPC_K), dtype=np.uint8)
    g[: C.HEADER_LDPC_K] = np.eye(C.HEADER_LDPC_K, dtype=np.uint8)
    for r in range(96):
        row = int(gen[r])
        for j in range(32):
            g[32 + r, j] = (row >> (31 - j)) & 1
    return g


@lru_cache(maxsize=1)
def load_parity_check() -> np.ndarray:
    """Parity-check matrix H ``[96, 128]`` parsed from the alist data file."""
    with open(os.path.join(_DATA_DIR, "header_ldpc.alist")) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    n, m = map(int, lines[0].split())
    h = np.zeros((m, n), dtype=np.uint8)
    for v in range(n):
        for c in map(int, lines[4 + v].split()):
            h[c - 1, v] = 1
    return h


@jax.jit
def encode_header(header_bits: jax.Array) -> jax.Array:
    """Encode header info bits -> repeated codeword bits.

    header_bits: uint8/int ``[B, 32]`` MSB-first info bits.
    Returns ``[B, 256]`` coded bits: the (128,32) codeword followed by its
    repetition (header_fec_encoder.hpp:93-115).
    """
    g = jnp.asarray(load_generator().T.astype(np.float32))  # [32, 128]
    # 0/1 operands with f32 accumulation of at most 32 terms: exact at any
    # matmul precision (TF32 included), so no precision is forced
    acc = jnp.dot(
        header_bits.astype(jnp.float32), g, preferred_element_type=jnp.float32
    )
    cw = (acc.astype(jnp.int32) & 1).astype(jnp.uint8)
    return jnp.concatenate([cw, cw], axis=-1)


class HeaderLdpcDecoder:
    """Batched normalized-min-sum BP decoder for the (128,32) header code."""

    def __init__(
        self,
        num_iterations: int = 25,
        normalization: float = 0.75,
        unroll: int | bool = 1,
    ):
        self.num_iterations = int(num_iterations)
        self.normalization = float(normalization)
        # lax.scan unroll of the iteration loop (True = fully unrolled)
        self.unroll = unroll
        h = load_parity_check()
        m, n = h.shape
        self.n = n
        deg = h.sum(axis=1)
        self.max_deg = int(deg.max())
        # dense padded edge table: var index per (check, slot), padding
        # slots point at variable 0 and are masked
        vidx = np.full((m, self.max_deg), 0, dtype=np.int32)
        vmask = np.zeros((m, self.max_deg), dtype=bool)
        for c in range(m):
            vs = np.nonzero(h[c])[0]
            vidx[c, : vs.size] = vs
            vmask[c, : vs.size] = True
        # variable -> flat edge indices [N, max var degree]; padding points
        # at edge E, a zero column appended to the messages
        e = m * self.max_deg
        var_edges = [[] for _ in range(n)]
        for ei in np.nonzero(vmask.reshape(-1))[0]:
            var_edges[vidx.reshape(-1)[ei]].append(ei)
        dv = max(len(v) for v in var_edges)
        vedge = np.full((n, dv), e, dtype=np.int32)
        for v, es in enumerate(var_edges):
            vedge[v, : len(es)] = es
        # numpy constants: embedded at trace time
        self._vidx = vidx
        self._vmask = vmask
        self._vedge = vedge
        self._h = h.astype(np.float32)

    @partial(jax.jit, static_argnums=0)
    def decode(self, llrs: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Decode a batch of codewords.

        llrs: float ``[B, 128]``, positive = bit 0 more likely (the modem's
        LLR convention, constellation_llr_decoder.hpp:24-27).
        Returns ``(info_bits [B, 32] uint8, ok [B] bool)`` where ``ok`` is the
        parity-check success flag (failure -> invalid_header upstream).
        """
        vmask = jnp.asarray(self._vmask)
        alpha = jnp.float32(self.normalization)
        m, dmax = self._vidx.shape
        b = llrs.shape[0]

        def var_sums(c2v):
            # sum of incoming check messages per variable (padding -> 0)
            contrib = jnp.where(vmask[None], c2v, 0.0).reshape(b, m * dmax)
            contrib = jnp.concatenate(
                [contrib, jnp.zeros((b, 1), contrib.dtype)], axis=1
            )
            return jnp.sum(contrib[:, self._vedge], axis=-1)  # [B, N]

        def check_update(v2c):
            # v2c: [B, M, D] variable-to-check messages (gathered)
            sgn = jnp.where(v2c >= 0, 1.0, -1.0)
            sgn = jnp.where(vmask[None], sgn, 1.0)
            mag = jnp.where(vmask[None], jnp.abs(v2c), jnp.inf)
            tot_sgn = jnp.prod(sgn, axis=-1, keepdims=True)
            # two smallest magnitudes
            m1 = jnp.min(mag, axis=-1, keepdims=True)
            arg1 = jnp.argmin(mag, axis=-1)
            mag2 = jnp.where(
                jax.nn.one_hot(arg1, mag.shape[-1], dtype=bool), jnp.inf, mag
            )
            m2 = jnp.min(mag2, axis=-1, keepdims=True)
            out_mag = jnp.where(mag == m1, m2, m1)
            out_sgn = tot_sgn * sgn  # product of the other signs
            return alpha * out_sgn * jnp.minimum(out_mag, jnp.float32(1e30))

        def body(c2v, _):
            # c2v: [B, M, D] check-to-variable messages
            total = llrs + var_sums(c2v)
            v2c = total[:, self._vidx] - c2v  # edge gather, extrinsic
            return check_update(v2c), None

        # derive the zeros from llrs so the carry inherits sharding/vma type
        # (required under shard_map's varying-axis checking)
        c2v0 = jnp.zeros((b, m, dmax), dtype=llrs.dtype) + (
            0.0 * llrs[:, :1, None]
        )
        c2v, _ = jax.lax.scan(
            body, c2v0, None, length=self.num_iterations, unroll=self.unroll
        )
        return self._finish(llrs + var_sums(c2v))

    def _finish(self, total):
        """Hard decision + parity syndrome check on the final totals."""
        hard = (total < 0).astype(jnp.uint8)  # positive LLR -> bit 0
        # 0/1 operands, at most 128 terms: exact at any matmul precision
        syndrome = jnp.dot(
            hard.astype(jnp.float32),
            jnp.asarray(self._h).T,
            preferred_element_type=jnp.float32,
        )
        ok = jnp.all((syndrome.astype(jnp.int32) & 1) == 0, axis=-1)
        return hard[:, : C.HEADER_LDPC_K], ok


@lru_cache(maxsize=4)
def make_header_decoder(num_iterations: int = 25) -> HeaderLdpcDecoder:
    return HeaderLdpcDecoder(num_iterations=num_iterations)


def combine_repetition(llrs256: jax.Array) -> jax.Array:
    """Sum the two repetition halves (header_fec_decoder.hpp:316-319)."""
    return llrs256[..., : C.HEADER_LDPC_N] + llrs256[..., C.HEADER_LDPC_N :]
