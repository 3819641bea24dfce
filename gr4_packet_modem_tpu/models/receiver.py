"""Batched packet receiver.

Re-design of the reference RX composite ``PacketReceiver``
(packet_receiver.hpp:28-267). The reference chains 15 per-item blocks with a
message feedback cycle (header parser -> payload_metadata_insert /
syncword_detection_filter). Here the cycle is restructured into feed-forward
passes over a sample buffer (SURVEY.md §7 hard-part 3):

1. **Acquire** (ops/acquire.py): block-parallel syncword correlation + CFAR ->
   sparse detections with amplitude/phase/frequency/time estimates.
2. **Header pass**: for every detection, extract the 192-symbol
   syncword+header region — coarse frequency derotation
   (coarse_frequency_correction.hpp) and polyphase matched filtering at the
   acquisition-selected arm (symbol_filter.hpp) run on one batched region
   slice per detection — wipe off the syncword (syncword_wipeoff.hpp), run the
   Costas loop (PILOT 64 @ bw 0.02, QPSK 128 @ bw 0.01), demap LLRs,
   descramble, decode the (128,32) LDPC header and parse it
   (header_parser.hpp).
3. **Filter**: suppress detections inside already-claimed packet extents (the
   SyncwordDetectionFilter / PayloadMetadataInsert in-packet logic) with one
   tiny scan over the sorted detections.
4. **Payload pass**: extract payload symbols, continue the Costas loop from
   the header-pass state at bw 0.005, demap, descramble (keystream continues
   from the header start), slice, pack, CRC-32 check (crc_check.hpp) and
   packet-type filter (packet_type_filter.hpp).

Symbol timing within a packet is fixed at acquisition (the reference's
free-running clock between syncwords does not affect decode), including the
reference's +1-sample adjustment for negative fractional time estimates
(symbol_filter.hpp:141-202).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ldpc
from ..ops.acquire import AcquisitionConfig, Detections, SyncwordAcquirer
from ..ops.costas_gpu import costas_track
from ..ops.crc import make_crc32_engine
from ..ops.matched import matched_filter
from ..ops.packing import pack_bits
from ..ops.scramble import keystream
from ..utils import constants as C
from ..utils.cplx import slice_windows
from ..utils.firdes import rx_pfb_taps, rx_rrc_taps

__all__ = [
    "RxConfig", "Receiver", "HeaderResult", "PayloadResult",
    "packet_extent_samples", "suppress_overlapping", "flatten_detections",
]

_HEADER_REGION_SYMS = C.SYNCWORD_LEN + C.HEADER_SYMBOLS  # 192


def packet_extent_samples(
    packet_length: jax.Array, header_ok: jax.Array, sps: int
) -> jax.Array:
    """Sample extent claimed by a detection: syncword+header plus — when the
    header decoded — the payload+CRC symbols (PayloadMetadataInsert's
    ``payload_symbols = 4*(packet_length + 4)``,
    payload_metadata_insert.hpp:227-234). Shared by ``filter_detections``
    and the streaming step so the geometry cannot drift."""
    payload_syms = 4 * (packet_length + C.CRC_NUM_BYTES)
    return jnp.where(
        header_ok,
        sps * (_HEADER_REGION_SYMS + payload_syms),
        sps * _HEADER_REGION_SYMS,
    )


def suppress_overlapping(
    index: jax.Array, valid: jax.Array, extent: jax.Array, busy0: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """In-packet suppression scan (SyncwordDetectionFilter +
    PayloadMetadataInsert): walk the index-sorted detections once, dropping
    any that start before ``busy_until``; kept detections claim
    ``[index, index + extent)``. ``busy0`` seeds the state (carried across
    blocks by the streaming driver). Returns ``(busy_end, keep)``."""

    def step(busy_until, xs):
        idx, v, ext = xs
        keep = v & (idx >= busy_until)
        busy_until = jnp.where(keep, idx + ext, busy_until)
        return busy_until, keep

    return jax.lax.scan(step, busy0, (index, valid, extent))


def flatten_grouped_results(
    detg: Detections, hdrg, resg, keepg
) -> tuple[Detections, "HeaderResult", "PayloadResult", jax.Array]:
    """Merge the leading group axis of per-group decode_bank results back
    into flat [C*D] rows (channel-group pipelining, Receiver.bank_step)."""
    # explicit merged dim: -1 is ill-defined for 0-size fields (symbols)
    flat = lambda a: a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])
    dch = detg.tree_flatten()[0]
    detf = Detections(*[flat(a) for a in dch[:-1]], jnp.any(dch[-1]))
    hdr = HeaderResult(*[flat(a) for a in hdrg.tree_flatten()[0]])
    res = PayloadResult(*[flat(a) for a in resg.tree_flatten()[0]])
    return detf, hdr, res, flat(keepg)


def flatten_detections(det: Detections) -> tuple[Detections, jax.Array]:
    """Flatten per-channel detections ``[C, D]`` into one ``[C*D]`` batch
    plus each row's channel id (channel-major row order)."""
    c, dd = det.index.shape
    chan = jnp.repeat(jnp.arange(c, dtype=jnp.int32), dd)
    detf = Detections(
        index=det.index.reshape(-1),
        valid=det.valid.reshape(-1),
        amplitude=det.amplitude.reshape(-1),
        phase=det.phase.reshape(-1),
        freq=det.freq.reshape(-1),
        freq_bin=det.freq_bin.reshape(-1),
        time_est=det.time_est.reshape(-1),
        noise_power=det.noise_power.reshape(-1),
        esn0_db=det.esn0_db.reshape(-1),
        overflow=jnp.any(det.overflow),
    )
    return detf, chan


@dataclass(frozen=True)
class RxConfig:
    samples_per_symbol: int = 4
    max_payload_len: int = 1536       # static payload byte bound
    max_detections: int = 64
    freq_bins: int = 4
    power_threshold: float = C.SYNC_POWER_THRESHOLD
    # "auto" = the overlap-save "fft" correlator (see
    # AcquisitionConfig.backend for all values)
    acquisition_backend: str = "auto"
    # overlap-save FFT size for the fft backend (syncword_detection.hpp uses
    # 2048; larger sizes trade fewer/bigger FFTs against overlap waste
    # (sync_len-1)/fft_size)
    acquisition_fft_size: int = C.SYNC_FFT_SIZE
    num_pfb_arms: int = 32
    ldpc_iterations: int = 25
    symbol_chunk: int = 2048          # symbol-extraction chunk size
    # payload carrier tracking: "costas" = loop-exact per-symbol Costas
    # loop (reference behavior); "vv" = feed-forward block Viterbi&Viterbi
    # estimator (no per-symbol recursion, within-SNR equivalent)
    payload_carrier: str = "costas"
    vv_block: int = 64                # V&V averaging block (symbols)
    # keep post-correction payload symbols in PayloadResult.symbols (for the
    # ZMQ monitoring taps, packet_receiver.hpp:159-189); off by default to
    # avoid the extra device->host traffic
    keep_payload_symbols: bool = False
    # Costas loop implementation (ops/costas_gpu.costas_track): None = the
    # Pallas kernel when compiled for a CUDA GPU, the lax.scan elsewhere;
    # True = the kernel (an error on a platform without one); False = the
    # scan. Both run the same recursion.
    use_pallas: bool | None = None
    # run the Pallas kernel in the Pallas interpreter, on any platform
    # (tests on the CPU)
    pallas_interpret: bool = False

    @property
    def max_payload_syms(self) -> int:
        return 4 * (self.max_payload_len + C.CRC_NUM_BYTES)


@jax.tree_util.register_pytree_node_class
@dataclass
class HeaderResult:
    """Per-detection header decode results (aligned with Detections rows)."""

    packet_length: jax.Array  # int32 [D]
    packet_type: jax.Array    # int32 [D]
    header_ok: jax.Array      # bool [D] (LDPC ok & length>0 & known type)
    phase: jax.Array          # float32 [D] Costas phase after header
    freq: jax.Array           # float32 [D] Costas freq after header
    arm: jax.Array            # int32 [D] PFB arm
    n_base: jax.Array         # int32 [D] sample of symbol 0 (history head)
    amp_scale: jax.Array      # float32 [D] 1/syncword_amplitude

    def tree_flatten(self):
        return (
            self.packet_length, self.packet_type, self.header_ok, self.phase,
            self.freq, self.arm, self.n_base, self.amp_scale,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class PayloadResult:
    data: jax.Array       # uint8 [D, max_payload_len] decoded payload bytes
    lengths: jax.Array    # int32 [D]
    crc_ok: jax.Array     # bool [D]
    accepted: jax.Array   # bool [D] full accept: kept & header & crc & type
    symbols: jax.Array    # float32 [D, S, 2] corrected payload symbol I/Q
    #                       planes ([D, 0, 2] unless keep_payload_symbols)

    def tree_flatten(self):
        return (
            self.data, self.lengths, self.crc_ok, self.accepted, self.symbols,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class Receiver:
    def __init__(self, config: RxConfig = RxConfig()):
        self.config = config
        sps = config.samples_per_symbol
        self.acquirer = SyncwordAcquirer(
            AcquisitionConfig(
                samples_per_symbol=sps,
                fft_size=config.acquisition_fft_size,
                freq_bins=config.freq_bins,
                power_threshold=config.power_threshold,
                max_detections=config.max_detections,
                backend=config.acquisition_backend,
            )
        )
        self.rrc_taps, _ = rx_rrc_taps(sps)
        self.filter_delay = self.rrc_taps.size - 1  # 44
        pfb = rx_pfb_taps(sps, config.num_pfb_arms)
        # per-arm taps [A, K]: arm j, tap k -> pfb[j + A*k]
        a = config.num_pfb_arms
        k = pfb.size // a
        # numpy constant: embedded at trace time
        self._arm_taps = pfb.reshape(k, a).T.astype(np.float32).copy()  # [A, K]
        self.arm_len = k
        self._sync_bipolar = np.where(
            np.asarray(C.SYNCWORD) != 0, -1.0, 1.0
        ).astype(np.float32)
        self._llr_scale = np.float32(2.0 / C.LLR_NOISE_SIGMA**2)
        self._decoder = ldpc.HeaderLdpcDecoder(config.ldpc_iterations)
        self._crc = make_crc32_engine(config.max_payload_len)

    # -------------------------------------------------------------- front pad

    @property
    def front_pad(self) -> int:
        # enough zero history for the CFAR window so a packet right at the
        # start of the capture is detectable, plus filter margin
        return C.SYNC_TIME_THRESHOLD + self.filter_delay + 20

    def pad_tail(self) -> int:
        """Lookahead needed past a syncword start: full packet extraction,
        plus the acquisition coverage margin — the overlap-save frames cover
        only ``nf * stride`` samples (up to stride-1 short of the buffer end)
        and the CFAR needs ``time_threshold`` of forward window for a
        detection to be eligible."""
        cfg = self.config
        sps = cfg.samples_per_symbol
        extraction = (
            sps * (_HEADER_REGION_SYMS + cfg.max_payload_syms) + self.arm_len + 8
        )
        acq_margin = C.SYNC_TIME_THRESHOLD + self.acquirer.config.fft_size
        return extraction + acq_margin

    # ---------------------------------------------------------- carrier track

    def _carrier_track(self, syms, phase0, freq0, offset: int):
        """Loop-exact Costas tracking with the receiver's positional schedule
        (PILOT 64 / QPSK-header 128 / QPSK-payload); the implementation is
        chosen per platform by ``costas_track``."""
        cfg = self.config
        return costas_track(
            syms, phase0, freq0, offset=offset, use_pallas=cfg.use_pallas,
            interpret=cfg.pallas_interpret,
        )

    # ---------------------------------------------------------- symbol timing

    def _timing(self, det: Detections):
        """PFB arm, base sample and adjusted phase per detection
        (symbol_filter.hpp:141-202)."""
        cfg = self.config
        neg = det.time_est < 0
        te = jnp.where(neg, det.time_est + 1.0, det.time_est)
        arm = jnp.clip(
            jnp.round(cfg.num_pfb_arms * te).astype(jnp.int32),
            0,
            cfg.num_pfb_arms - 1,
        )
        n_base = det.index + self.filter_delay - neg.astype(jnp.int32)
        phase0 = jnp.where(neg, det.phase - det.freq, det.phase)
        return arm, n_base, phase0

    # ------------------------------------------------------ symbol extraction

    def _extract_symbols(
        self,
        x: jax.Array,
        n_base: jax.Array,
        arm: jax.Array,
        freq: jax.Array,
        n0: jax.Array,
        amp_scale: jax.Array,
        sym_offset: int,
        num_syms: int,
        chan: jax.Array | None = None,
    ) -> jax.Array:
        """Matched-filter ``num_syms`` symbols starting at symbol
        ``sym_offset`` for each detection: coarse freq derotation + polyphase
        arm filtering + amplitude normalization, chunked over symbols.

        Output symbol s uses samples ``x[n_base + sps*(sym_offset+s) - k]``,
        k = 0..K-1, derotated by ``exp(-i freq (n - n0))``.

        Bank form: ``x`` may be ``[C, N]`` with ``chan`` int32
        ``[D]`` giving each detection's channel — all channels' detections
        are then extracted in ONE batch (the slices address the flattened
        sample matrix; indices stay channel-local for the derotation).
        """
        cfg = self.config
        sps = cfg.samples_per_symbol
        kk = self.arm_len
        arm_taps = jnp.asarray(self._arm_taps)[arm]  # [D, K] row gather
        # extraction runs as one chunk up to ~16k symbols; longer extractions
        # (the u16 payload envelope reaches 262,156 symbols) are chunked to
        # bound the [D, region] intermediates
        if num_syms > 4 * cfg.symbol_chunk:
            chunk = cfg.symbol_chunk
            nchunks = -(-num_syms // chunk)
        else:
            chunk = num_syms
            nchunks = 1
        if x.ndim == 2:
            row_len = x.shape[1]
            xr, xi = x.real.reshape(-1), x.imag.reshape(-1)
        else:
            row_len = x.shape[0]
            xr, xi = x.real, x.imag
        region_len = sps * (chunk - 1) + kk
        taps_rev = arm_taps[:, ::-1]  # correlation form

        def one_chunk(c):
            start = n_base + sps * (sym_offset + c * chunk) - (kk - 1)  # [D]
            # clip within the (channel-local) row, then address the flat
            # sample matrix
            start_c = jnp.clip(start, 0, row_len - region_len)
            fetch_start = (
                start_c if chan is None else start_c + chan * row_len
            )
            # per-detection contiguous regions, one batched slice per plane
            rr = slice_windows(xr, fetch_start, region_len)  # [D, region]
            ri = slice_windows(xi, fetch_start, region_len)
            start = start_c
            # derotate the region by exp(-i freq (n - n0))
            j = jnp.arange(region_len, dtype=jnp.int32)[None, :]
            ph = -freq[:, None] * (start[:, None] + j - n0[:, None]).astype(
                jnp.float32
            )
            cph, sph = jnp.cos(ph), jnp.sin(ph)
            dr = rr * cph - ri * sph
            di = rr * sph + ri * cph
            outr, outi = matched_filter(dr, di, taps_rev, sps, chunk)
            sym = jax.lax.complex(outr, outi)  # [D, chunk]
            return amp_scale[:, None] * sym

        if nchunks == 1:
            out = one_chunk(0)  # [D, chunk]
        else:
            # one traced chunk body keeps the program small
            chunks = jax.lax.map(one_chunk, jnp.arange(nchunks))
            out = jnp.moveaxis(chunks, 0, 1).reshape(
                n_base.shape[0], nchunks * chunk
            )
        return out[:, :num_syms]  # [D, num_syms]

    # ------------------------------------------------------------ header pass

    @partial(jax.jit, static_argnums=0)
    def decode_headers(
        self, x: jax.Array, det: Detections, chan: jax.Array | None = None
    ) -> tuple[HeaderResult, jax.Array]:
        """Decode the header of every detection. ``x`` must be padded with
        ``front_pad`` zeros in front (detection indices are relative to
        ``x``). Returns (HeaderResult, header+sync symbols [D, 192]).
        Bank form: ``x`` ``[C, N]`` + ``chan`` ``[D]`` (see decode_bank)."""
        arm, n_base, phase0 = self._timing(det)
        amp_scale = 1.0 / jnp.maximum(det.amplitude, 1e-9)
        syms = self._extract_symbols(
            x, n_base, arm, det.freq, det.index, amp_scale, 0,
            _HEADER_REGION_SYMS, chan,
        )
        # wipe off the syncword modulation -> pure pilot
        wipe = jnp.concatenate(
            [self._sync_bipolar, jnp.ones(C.HEADER_SYMBOLS, jnp.float32)]
        )
        syms = syms * wipe[None]
        corrected, ph_end, fr_end = self._carrier_track(
            syms, phase0, jnp.zeros_like(phase0), offset=0
        )
        hdr_syms = corrected[:, C.SYNCWORD_LEN :]  # [D, 128]
        llrs = jnp.stack(
            [hdr_syms.real, hdr_syms.imag], axis=-1
        ).reshape(hdr_syms.shape[0], -1) * self._llr_scale  # [D, 256]
        ks = keystream(C.HEADER_LLRS)
        llrs = jnp.where(ks.astype(bool)[None], -llrs, llrs)
        comb = ldpc.combine_repetition(llrs)
        bits, ldpc_ok = self._decoder.decode(comb)  # [D, 32], [D]
        hdr_bytes = pack_bits(bits, 8)  # [D, 4]
        packet_length = (hdr_bytes[:, 0] << 8 | hdr_bytes[:, 1]).astype(jnp.int32)
        type_field = hdr_bytes[:, 2].astype(jnp.int32)
        header_ok = (
            ldpc_ok
            & det.valid
            & (packet_length > 0)
            & (type_field <= 1)
            & (packet_length <= self.config.max_payload_len)
        )
        return (
            HeaderResult(
                packet_length=packet_length,
                packet_type=type_field,
                header_ok=header_ok,
                phase=ph_end,
                freq=fr_end,
                arm=arm,
                n_base=n_base,
                amp_scale=amp_scale,
            ),
            corrected,
        )

    # --------------------------------------------------- detection filtering

    @partial(jax.jit, static_argnums=0)
    def filter_detections(self, det: Detections, hdr: HeaderResult) -> jax.Array:
        """Suppress detections that start inside an earlier accepted packet's
        extent (SyncwordDetectionFilter + PayloadMetadataInsert in-packet
        suppression). Detections are index-sorted with invalid entries last."""
        extent = packet_extent_samples(
            hdr.packet_length, hdr.header_ok, self.config.samples_per_symbol
        )
        _, keep = suppress_overlapping(
            det.index,
            det.valid,
            extent,
            det.index[0] * 0 - 1,  # -1, derived from inputs for vma typing
        )
        return keep

    # ------------------------------------------------------ batched bank decode

    @partial(jax.jit, static_argnums=(0, 3))
    def decode_bank(
        self, x: jax.Array, det: Detections, upto: str = "full"
    ) -> tuple:
        """Decode ALL channels' detections in one flat batch.

        ``x``: ``[C, N]`` complex64; ``det``: per-channel detections with
        fields ``[C, D]`` (from a vmapped ``acquire``). The C x D detections
        run as ONE batch: one Costas tracking call over C x D rows, one
        [C*D, 128] LDPC batch and one matched-filter call. In-packet
        suppression stays per-channel (a vmapped tiny scan — detections on
        different channels must not suppress each other).

        Returns ``(det_flat, hdr, res, keep)`` with all fields flattened to
        ``[C*D]`` rows ordered channel-major (row ``c*D + i``). ``upto``
        truncates the pipeline for stage profiling: "headers" ->
        ``(det_flat, hdr)``, "filter" -> ``(det_flat, hdr, keep)``."""
        c, dd = det.index.shape
        detf, chan = flatten_detections(det)
        hdr, _ = self.decode_headers(x, detf, chan)
        if upto == "headers":
            return detf, hdr
        extent = packet_extent_samples(
            hdr.packet_length, hdr.header_ok, self.config.samples_per_symbol
        )
        _, keep = jax.vmap(
            lambda i, v, e: suppress_overlapping(i, v, e, i[0] * 0 - 1)
        )(det.index, det.valid, extent.reshape(c, dd))
        keep = keep.reshape(-1)
        if upto == "filter":
            return detf, hdr, keep
        res = self.decode_payloads(x, detf, hdr, keep, chan)
        return detf, hdr, res, keep

    @partial(jax.jit, static_argnums=(0, 2))
    def bank_step(
        self, x: jax.Array, group: int = 16
    ) -> tuple[Detections, HeaderResult, PayloadResult, jax.Array]:
        """Acquire + decode a whole channel bank ``[C, N]`` (acquisition
        vmapped per channel; the decode passes run as one batch over all
        channels' detections).

        ``group`` enables channel-group pipelining: banks wider than
        ``group`` channels run as a ``lax.map`` over groups, bounding the
        working set (the [C*D, region] intermediates of the decode passes)
        and the size of the compiled program. Set ``group=0`` to force the
        monolithic program. Results are flattened to the same [C*D]-row
        layout either way."""
        if not (0 < group < x.shape[0] and x.shape[0] % group == 0):
            det = jax.vmap(lambda xc: self.acquirer.acquire(xc))(x)
            return self.decode_bank(x, det)
        gs = x.reshape(x.shape[0] // group, group, x.shape[1])

        def one(g):
            det = jax.vmap(lambda xc: self.acquirer.acquire(xc))(g)
            return self.decode_bank(g, det)

        return flatten_grouped_results(*jax.lax.map(one, gs))

    # -------------------------------------------- feed-forward carrier track

    def _vv_track(
        self, syms: jax.Array, phase0: jax.Array, freq0: jax.Array
    ) -> jax.Array:
        """Scan-free payload carrier tracking: propagate the header-end loop
        state linearly, then refine with a block Viterbi&Viterbi 4th-power
        estimator (phase mod pi/2 per block, ambiguity resolved by continuity
        with the propagated state; cumulative-sum unwrap across blocks).

        Within-SNR equivalent to the Costas loop at payload bandwidth: the
        loop's 0.005 B_L*T corresponds to ~a 60-symbol averaging window.
        """
        blk = self.config.vv_block
        d, s = syms.shape
        nb = s // blk
        idx = jnp.arange(s, dtype=jnp.float32)
        base_phase = phase0[:, None] + freq0[:, None] * idx[None, :]
        z = syms * jax.lax.complex(jnp.cos(base_phase), -jnp.sin(base_phase))
        # block 4th-power phase residuals (mod pi/2)
        z4 = (z[:, : nb * blk].reshape(d, nb, blk)) ** 4
        m4 = z4.mean(axis=-1)
        ph4 = jnp.angle(m4)  # 4 * residual phase, wrapped to [-pi, pi]
        # incremental unwrap: residual increments are << pi/4 per block
        d4 = jnp.diff(ph4, axis=-1)
        d4 = jnp.where(d4 > np.pi, d4 - 2 * np.float32(np.pi), d4)
        d4 = jnp.where(d4 < -np.pi, d4 + 2 * np.float32(np.pi), d4)
        # QPSK points sit at 45 degrees, so z^4 carries a pi offset:
        # angle(z^4) = pi + 4*residual. Resolve the first block's pi/2
        # ambiguity by wrapping to [-pi/4, pi/4) (residual is small after the
        # header's Costas lock).
        resid0 = (ph4[:, :1] - np.float32(np.pi)) / 4.0
        resid0 = (resid0 + np.float32(np.pi / 4)) % np.float32(np.pi / 2) - (
            np.float32(np.pi / 4)
        )
        resid = jnp.concatenate(
            [resid0, resid0 + jnp.cumsum(d4 / 4.0, axis=-1)], axis=-1
        )  # [D, nb] per-block residual phase
        # linear interpolation between block centres, clamped at the ends.
        # The weights depend only on the static (S, blk) geometry, so the
        # interpolation is one [D, nb] @ [nb, S] matmul instead of two
        # [D, S] gathers. The two-diagonal matrix is built on device from
        # iota comparisons (as a trace-time literal it is O(nb*S): ~4.3 GB
        # at the u16 payload envelope). Above a size threshold the gather
        # formulation wins on memory and is used instead. The matmul runs
        # at full f32 precision: a default-precision f32 dot may run in
        # TF32 on the GPU.
        pos_np = (np.arange(s) - (blk - 1) / 2.0) / blk
        b0_np = np.clip(np.floor(pos_np).astype(np.int32), 0, nb - 1)
        b1_np = np.clip(b0_np + 1, 0, nb - 1)
        frac_np = np.clip(pos_np - b0_np, 0.0, 1.0).astype(np.float32)
        if nb * s <= (1 << 25):  # <=128 MB of on-device interp matrix
            b0 = jnp.asarray(b0_np)
            b1 = jnp.asarray(b1_np)
            frac = jnp.asarray(frac_np)
            rows = jnp.arange(nb, dtype=jnp.int32)[:, None]  # [nb, 1]
            interp = (rows == b0[None, :]) * (1.0 - frac)[None, :] + (
                rows == b1[None, :]
            ) * frac[None, :]
            resid_per_sym = jnp.dot(
                resid, interp, precision=jax.lax.Precision.HIGHEST
            )
        else:
            resid_per_sym = (
                resid[:, b0_np] * (1.0 - frac_np)[None, :]
                + resid[:, b1_np] * frac_np[None, :]
            )
        return z * jax.lax.complex(
            jnp.cos(resid_per_sym), -jnp.sin(resid_per_sym)
        )

    # ----------------------------------------------------------- payload pass

    @partial(jax.jit, static_argnums=0)
    def decode_payloads(
        self,
        x: jax.Array,
        det: Detections,
        hdr: HeaderResult,
        keep: jax.Array,
        chan: jax.Array | None = None,
    ) -> PayloadResult:
        cfg = self.config
        s_pay = cfg.max_payload_syms
        syms = self._extract_symbols(
            x, hdr.n_base, hdr.arm, det.freq, det.index, hdr.amp_scale,
            _HEADER_REGION_SYMS, s_pay, chan,
        )
        if cfg.payload_carrier == "vv":
            corrected = self._vv_track(syms, hdr.phase, hdr.freq)
        else:
            corrected, _, _ = self._carrier_track(
                syms, hdr.phase, hdr.freq, offset=_HEADER_REGION_SYMS
            )
        llrs = jnp.stack(
            [corrected.real, corrected.imag], axis=-1
        ).reshape(corrected.shape[0], -1) * self._llr_scale  # [D, 2*s_pay]
        ks = keystream(C.HEADER_LLRS + 2 * s_pay)[C.HEADER_LLRS :]
        llrs = jnp.where(ks.astype(bool)[None], -llrs, llrs)
        bits = (llrs < 0).astype(jnp.uint8)  # invert=true slicer
        all_bytes = pack_bits(bits, 8).astype(jnp.uint8)  # [D, s_pay/4]
        plen = hdr.packet_length
        payload = all_bytes[:, : cfg.max_payload_len]
        # mask bytes beyond each packet's length
        pos = jnp.arange(cfg.max_payload_len, dtype=jnp.int32)[None, :]
        payload = jnp.where(pos < plen[:, None], payload, 0)
        crc = self._crc.compute(payload, jnp.clip(plen, 0, cfg.max_payload_len))
        # received CRC: 4 bytes at positions plen..plen+4, selected by an
        # iota comparison + sum (one fused pass, no per-row slices)
        plen_c = jnp.clip(plen, 0, all_bytes.shape[1] - C.CRC_NUM_BYTES)
        jpos = jnp.arange(all_bytes.shape[1], dtype=jnp.int32)
        crc_rx_bytes = jnp.stack(
            [
                jnp.sum(
                    all_bytes.astype(jnp.int32)
                    * (jpos[None, :] == (plen_c + i)[:, None]),
                    axis=1,
                )
                for i in range(C.CRC_NUM_BYTES)
            ],
            axis=-1,
        ).astype(jnp.uint8)
        crc_rx = (
            (crc_rx_bytes[:, 0].astype(jnp.uint32) << 24)
            | (crc_rx_bytes[:, 1].astype(jnp.uint32) << 16)
            | (crc_rx_bytes[:, 2].astype(jnp.uint32) << 8)
            | crc_rx_bytes[:, 3].astype(jnp.uint32)
        )
        # mask by keep: suppressed/invalid detection slots hold garbage
        # extractions and must not report a (coincidental) CRC pass
        crc_ok = (crc == crc_rx) & keep
        accepted = (
            keep
            & hdr.header_ok
            & crc_ok
            & (hdr.packet_type == int(C.PacketType.USER_DATA))
        )
        if cfg.keep_payload_symbols:
            sym_planes = jnp.stack([corrected.real, corrected.imag], axis=-1)
        else:
            sym_planes = jnp.zeros((corrected.shape[0], 0, 2), jnp.float32)
        return PayloadResult(
            data=payload, lengths=plen, crc_ok=crc_ok, accepted=accepted,
            symbols=sym_planes,
        )

    # -------------------------------------------------------------- high level

    def receive(self, samples: np.ndarray) -> PayloadResult:
        """One-shot receive over a full capture (packet_receiver_file path).

        Pads the buffer, acquires, decodes headers, filters overlapping
        detections and decodes payloads. Rows of the result are aligned with
        the (sorted) detection set; ``accepted`` marks decoded user packets.
        """
        fp = self.front_pad
        from ..utils.cplx import to_device

        x = jnp.concatenate(
            [
                jnp.zeros(fp, jnp.complex64),
                to_device(np.asarray(samples, np.complex64))
                if isinstance(samples, np.ndarray)
                else jnp.asarray(samples, jnp.complex64),
                jnp.zeros(self.pad_tail(), jnp.complex64),
            ]
        )
        det = self.acquirer.acquire(x, index0=0)
        hdr, _ = self.decode_headers(x, det)
        keep = self.filter_detections(det, hdr)
        return self.decode_payloads(x, det, hdr, keep)
