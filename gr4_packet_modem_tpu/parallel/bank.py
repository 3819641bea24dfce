"""Multi-chip receiver bank: channels x time sharding with halo exchange.

The reference is a single-process dataflow program (SURVEY.md §2.4); its
scale-out here shards a many-channel receiver bank over a device mesh:

- ``ch`` axis (data-parallel analogue): independent RF channels.
- ``time`` axis (sequence-parallel analogue): each device owns a contiguous
  time shard of every channel it holds; the overlap-save style lookback and
  lookahead that the reference implements with ring-buffer history
  (syncword_detection.hpp:236-238, HistoryBuffer) becomes a **halo exchange**
  between time-neighbour devices via ``lax.ppermute`` collectives (NCCL
  between GPUs).

Each device then runs the identical single-chip receiver program (acquire ->
header pass -> filter -> payload pass) on its extended local block. Detection
semantics match the single-chip path exactly at shard boundaries:

- candidate selection is restricted to each shard's own fresh window
  *before* the top-k (``fresh_lo``/``fresh_hi`` in ``acquire``), so strong
  peaks in the halo cannot consume ``max_detections`` slots (they are the
  left neighbour's own detections);
- the in-packet suppression scan chains across time shards: the per-shard
  detection metadata (index, valid, extent — a few dozen int32s) is
  all-gathered along the time axis and EVERY shard runs the identical full
  scan over the concatenated, globally index-sorted list, then keeps its own
  segment's flags (replicating a tiny scan instead of serializing devices —
  syncword_detection_filter.hpp:4-18's single-stream semantics on a mesh).

Packets crossing the shard boundary are decoded by the owning shard via the
right halo (sized to the maximum packet extent). Per-device results are
returned sharded; the only data-path collectives are the halos and the
detection-metadata all-gather.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.receiver import (
    Receiver,
    RxConfig,
    flatten_detections,
    packet_extent_samples,
    suppress_overlapping,
)

__all__ = [
    "BankConfig", "ReceiverBank", "make_mesh", "sharded_group_decode",
]


def sharded_group_decode(
    rx: Receiver,
    g_ext: jax.Array,
    g_busy0: jax.Array,
    *,
    fresh_lo: int,
    fresh_len: int,
    shard_pos: jax.Array,
    t_axis: str,
):
    """Decode one channel group's extended buffers on one time shard with
    single-chip-identical suppression semantics across shards.

    ``g_ext``: ``[G, L]`` complex64 extended buffers (halo/history + own
    window + lookahead); ``g_busy0``: ``[G]`` int32 suppression seed in
    *chain* coordinates; ``fresh_lo``/``fresh_len``: this shard's own fresh
    window ``[fresh_lo, fresh_lo+fresh_len)`` in buffer coordinates;
    ``shard_pos``: offset mapping buffer coords to chain coords
    (``chain = index + shard_pos``); ``t_axis``: time mesh axis name.

    Returns ``(detf, hdr, res, keep, busy_end)`` with rows flattened to
    ``[G*D]`` (channel-major) and ``busy_end`` ``[G]`` in chain coords (the
    final scan state, identical on every time shard).
    """
    import dataclasses as _dc

    cfg = rx.config
    dd = cfg.max_detections
    det = jax.vmap(
        lambda xc: rx.acquirer.acquire(
            xc, fresh_lo=np.int32(fresh_lo),
            fresh_hi=np.int32(fresh_lo + fresh_len),
        )
    )(g_ext)
    detf, chan = flatten_detections(det)
    hdr, _ = rx.decode_headers(g_ext, detf, chan)
    g = g_ext.shape[0]
    extent = packet_extent_samples(
        hdr.packet_length, hdr.header_ok, cfg.samples_per_symbol
    ).reshape(g, dd)
    # chain the suppression scan across time shards: gather every shard's
    # (index, valid, extent) — shard k's rows land at [k*D, (k+1)*D), and
    # since fresh windows are disjoint ascending and each shard's rows are
    # index-sorted (invalid last, never claiming), the concatenation is
    # globally index-sorted over the valid entries
    chain_idx = det.index + shard_pos  # [G, D] buffer -> chain coords
    gather = lambda a: jax.lax.all_gather(a, t_axis, axis=1).reshape(
        g, -1
    )  # [G, nt*D]
    all_idx = gather(chain_idx)
    all_valid = gather(det.valid)
    all_ext = gather(extent)
    busy_end, keep_all = jax.vmap(suppress_overlapping)(
        all_idx, all_valid, all_ext, g_busy0
    )
    my_t = jax.lax.axis_index(t_axis)
    keep = jax.lax.dynamic_slice(
        keep_all, (jnp.int32(0), my_t * dd), (g, dd)
    ).reshape(-1)
    res = rx.decode_payloads(g_ext, detf, hdr, keep, chan)
    # valid is already fresh-window-restricted; propagate keep into detf so
    # consumers see the final per-row verdict
    detf = _dc.replace(detf, valid=detf.valid & keep)
    return detf, hdr, res, keep, busy_end


def make_mesh(n_devices: int | None = None, time_shards: int | None = None) -> Mesh:
    """Build a 2D (ch, time) mesh over the first ``n_devices`` devices.
    The mesh follows the algorithm only: the collectives are a time-axis
    ppermute/all-gather, and every GPU of a host reaches every other over
    NVLink, so device order does not matter."""
    devices = np.array(jax.devices())
    n = n_devices or devices.size
    devices = devices[:n]
    if time_shards is None:
        # prefer a modest time dimension; channels carry most parallelism
        time_shards = 2 if n % 2 == 0 and n >= 2 else 1
    ch_shards = n // time_shards
    return Mesh(devices.reshape(ch_shards, time_shards), ("ch", "time"))


@dataclass(frozen=True)
class BankConfig:
    num_channels: int = 64
    block_samples: int = 1 << 17  # per time shard, per channel
    rx: RxConfig = RxConfig()
    # channel-group pipelining within each device's local step: bounds the
    # [C_loc*D, region] working set (Receiver.bank_step)
    channel_group: int = 16


class ReceiverBank:
    """Sharded receiver bank over a (ch, time) mesh."""

    def __init__(self, mesh: Mesh, config: BankConfig = BankConfig()):
        self.mesh = mesh
        self.config = config
        self.rx = Receiver(config.rx)
        # halo sizes: left lookback for CFAR + filter history, right lookahead
        # for packets extending past the shard end
        self.left_halo = self.rx.front_pad
        self.right_halo = self.rx.pad_tail()
        self._step = self._build_step()

    # ------------------------------------------------------------------ build

    def _build_step(self):
        rx = self.rx
        mesh = self.mesh
        lh, rh = self.left_halo, self.right_halo
        t_axis = "time"

        def local_step(x_loc: jax.Array):
            """x_loc: [C_loc, T_loc] complex64 — this device's shard."""
            t_loc = x_loc.shape[1]
            nt = jax.lax.psum(1, t_axis)
            idx_t = jax.lax.axis_index(t_axis)
            # left halo: last lh samples of the left time-neighbour
            left_src = [(i, (i + 1) % nt) for i in range(nt)]
            left = jax.lax.ppermute(x_loc[:, -lh:], t_axis, left_src)
            left = jnp.where(idx_t == 0, 0.0, 1.0).astype(x_loc.dtype) * left
            # right halo: first rh samples of the right time-neighbour
            right_src = [(i, (i - 1) % nt) for i in range(nt)]
            right = jax.lax.ppermute(x_loc[:, :rh], t_axis, right_src)
            right = (
                jnp.where(idx_t == nt - 1, 0.0, 1.0).astype(x_loc.dtype) * right
            )
            ext = jnp.concatenate([left, x_loc, right], axis=1)

            # chain coords = global signal coords: buffer index i on shard t
            # is global sample i - lh + t*t_loc
            shard_pos = idx_t * jnp.int32(t_loc) - jnp.int32(lh)

            def decode_group(g):
                seed = jnp.full((g.shape[0],), -(1 << 30), jnp.int32)
                detf, hdr, res, keep, _ = sharded_group_decode(
                    rx, g, seed, fresh_lo=lh, fresh_len=t_loc,
                    shard_pos=shard_pos, t_axis=t_axis,
                )
                return res

            c_loc = ext.shape[0]
            cg = self.config.channel_group
            if 0 < cg < c_loc and c_loc % cg == 0:
                # channel-group pipelining (see BankConfig.channel_group);
                # the chain all-gather inside the map body is collective-
                # matched across shards (every shard runs the same groups in
                # the same order)
                resg = jax.lax.map(
                    decode_group, ext.reshape(c_loc // cg, cg, ext.shape[1])
                )
                res = jax.tree.map(
                    lambda a: a.reshape((a.shape[0] * a.shape[1],)
                                        + a.shape[2:]),
                    resg,
                )
            else:
                res = decode_group(ext)
            dd = rx.config.max_detections
            # back to [C_loc, D, ...] rows for the (ch, time) out sharding
            return jax.tree.map(
                lambda a: a.reshape((c_loc, dd) + a.shape[1:]), res
            )

        in_spec = P("ch", "time")
        out_spec = P("ch")  # per-channel results, time-sharded work reduced
        # results stay sharded over ch; each time shard returns its own rows —
        # stack along a new leading 'time' axis instead of reducing
        step = shard_map(
            local_step,
            mesh=mesh,
            in_specs=(in_spec,),
            out_specs=P("ch", "time"),
            # the receiver's Pallas kernel returns ShapeDtypeStruct outputs
            # without vma annotations; every output of local_step is fully
            # local to its shard, so the varying-axis check adds nothing
            check_vma=False,
        )
        return jax.jit(step)

    # -------------------------------------------------------------------- api

    def sharding(self):
        return NamedSharding(self.mesh, P("ch", "time"))

    def step(self, samples: jax.Array):
        """samples: [num_channels, total_samples] with total_samples divisible
        by the time-mesh size. Returns per-(channel, det) PayloadResult with
        fields shaped [C, time_shards * D, ...]."""
        return self._step(samples)
