"""Host-fed sharded serving driver: StreamingBank semantics on a device mesh.

The reference's serving story is its free-running real-time apps — one
process feeding samples to one receiver graph (apps/packet_transceiver.cpp:
99-131, tun_source.hpp:69-78). ``StreamingBank`` scales that to a channel
bank on ONE chip; ``StreamingShardedBank`` composes it with the sharded
``ReceiverBank`` execution model: the host feeds
``[C, block]`` sample blocks onto a ``(ch, time)`` mesh and every
StreamingBank guarantee carries over — exactly-once decode across block
boundaries, per-channel in-packet suppression state carried across blocks
AND shards, the int8 wire, the compacted d2h, and the parity/overflow gates.

Design:

- **h2d is mesh-sharded**: each device receives only its ``[2, C_loc, bs]``
  slice of the wire block (``device_put`` with a ``(ch, time)`` sharding);
  the full per-channel block is reassembled ON the mesh by an ``all_gather``
  along the time axis — the device interconnect (NVLink between GPUs) is
  far faster than the host link, so the host wire stays 1/N.
- **The sliding window is carried, not re-fed**: only the last
  ``front_pad + pad_tail`` samples per channel (the overlap the next block's
  fresh region needs) persist on device between steps, exactly like the
  single-chip driver's donated buffer slide.
- **Each time shard decodes a static slice of the window** — shard ``i``
  takes ``window[:, i*bs : i*bs + front_pad + bs + pad_tail]`` and detects
  only in its own fresh sub-window ``[front_pad, front_pad + bs)``; the
  in-packet suppression scan chains across shards through the all-gathered
  detection metadata (``parallel.bank.sharded_group_decode``), seeded by the
  per-channel busy state carried across blocks. The degenerate 1x1 mesh
  reproduces ``StreamingBank`` bit-for-bit.
- **Results return compacted per mesh cell**: each device packs its own
  accepted rows (``pack_result_wire``) and the host reads one concatenated
  byte buffer per block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.receiver import RxConfig
from ..runtime.streaming import (
    DecodedPacket,
    StreamingBank,
    _flag_overflows,
    _log_packet,
    pack_result_wire,
    unpack_result_wire,
    wire_bytes,
    wire_slots,
)
from .bank import sharded_group_decode

__all__ = ["StreamingShardedBank"]


class StreamingShardedBank(StreamingBank):
    """Host-fed multi-channel streaming receiver over a ``(ch, time)`` mesh.

    Same API and semantics as :class:`StreamingBank` (``process([C, n])`` /
    ``flush()`` / ``stats`` / parity gates); ``result_budget`` is interpreted
    PER MESH CELL (each ``(ch_shard, time_shard)`` device compacts its own
    rows to that many slots).
    """

    def __init__(
        self,
        mesh: Mesh,
        config: RxConfig = RxConfig(),
        channels: int = 8,
        block: int = 1 << 18,
        transfer_dtype=None,
        pipeline_depth: int = 2,
        group: int = 16,
        result_budget: int | None = None,
        log: bool = False,
    ):
        if tuple(mesh.axis_names) != ("ch", "time"):
            raise ValueError("mesh axes must be ('ch', 'time') — make_mesh")
        c_shards, t_shards = mesh.devices.shape
        if channels % c_shards:
            raise ValueError(f"{channels} channels not divisible by "
                             f"{c_shards} ch shards")
        if block % t_shards:
            raise ValueError(f"block {block} not divisible by {t_shards} "
                             "time shards")
        self.mesh = mesh
        self.c_shards, self.t_shards = c_shards, t_shards
        self.c_loc = channels // c_shards
        self.bs = block // t_shards
        # StreamingBank.__init__ builds the single-device buffer/step; run it
        # first, then replace the carried state and step with sharded ones
        super().__init__(
            config,
            channels=channels,
            block=block,
            transfer_dtype=transfer_dtype,
            pipeline_depth=pipeline_depth,
            group=group if 0 < group < self.c_loc and self.c_loc % group == 0
            else 0,
            result_budget=result_budget,
            log=log,
        )
        fp, pt = self.fp, self.pt
        if self.bs < 1:
            raise ValueError("block too small for the time mesh")
        c = self.channels
        # carried tail: the last fp+pt samples of the window, sharded over
        # ch and replicated over time (built on device, no h2d transfer)
        self._buf = jax.jit(
            lambda: jax.lax.complex(
                jnp.zeros((c, fp + pt), jnp.float32),
                jnp.zeros((c, fp + pt), jnp.float32),
            ),
            out_shardings=NamedSharding(mesh, P("ch", None)),
        )()
        self._busy_dev = jax.device_put(
            np.full((c,), -(1 << 30), np.int32),
            NamedSharding(mesh, P("ch")),
        )
        self._wire_sharding = NamedSharding(mesh, P(None, "ch", "time"))
        self._step = jax.jit(self._make_sharded_step(), donate_argnums=0)

    # ------------------------------------------------------------------ build

    def _make_sharded_step(self):
        rx = self.rx
        from ..utils.cplx import planes_to_complex

        fp, pt, bs, block = self.fp, self.pt, self.bs, self.block
        dd = rx.config.max_detections
        c_loc, group = self.c_loc, self.group
        budget = self.result_budget

        def local_step(tail_loc, planes_loc, busy_loc):
            # [C_loc, fp+pt], [2, C_loc, bs], [C_loc]
            planes_full = jax.lax.all_gather(
                planes_loc, "time", axis=2, tiled=True
            )  # [2, C_loc, block] — reassemble the block on the mesh
            chunk = planes_to_complex(
                planes_full, packed_int4=self.transfer_dtype == "int4"
            )  # [C_loc, block] — int4 also halves the gather bytes
            window = jnp.concatenate([tail_loc, chunk], axis=1)
            tail_next = window[:, block:]  # last fp+pt (identical per shard)
            idx_t = jax.lax.axis_index("time")
            sub = jax.lax.complex(
                jax.lax.dynamic_slice(
                    window.real, (0, idx_t * bs), (c_loc, fp + bs + pt)
                ),
                jax.lax.dynamic_slice(
                    window.imag, (0, idx_t * bs), (c_loc, fp + bs + pt)
                ),
            )
            shard_pos = idx_t * jnp.int32(bs)  # sub -> window coords

            def decode_group(args):
                g, g_busy = args
                detf, hdr, res, keep, busy_end = sharded_group_decode(
                    rx, g, g_busy, fresh_lo=fp, fresh_len=bs,
                    shard_pos=shard_pos, t_axis="time",
                )
                return (
                    detf.index + shard_pos,  # window coords
                    res.lengths, hdr.packet_type, detf.esn0_db, detf.freq,
                    hdr.arm, res.accepted, res.data,
                    jnp.any(detf.overflow), busy_end,
                )

            if group:
                ng = c_loc // group
                outs = jax.lax.map(
                    decode_group,
                    (
                        sub.reshape(ng, group, fp + bs + pt),
                        busy_loc.reshape(ng, group),
                    ),
                )
                (idx, lens, types, esn0, freq, arm, acc, data, ovf,
                 busy_end) = outs
                flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
                idx, lens, types, esn0, freq, arm, acc, data, busy_end = (
                    flat(o) for o in (idx, lens, types, esn0, freq, arm,
                                      acc, data, busy_end)
                )
                overflow = jnp.any(ovf)
            else:
                (idx, lens, types, esn0, freq, arm, acc, data, overflow,
                 busy_end) = decode_group((sub, busy_loc))
            busy_next = jnp.maximum(
                busy_end.reshape(-1) - jnp.int32(block), -(1 << 30)
            )
            chan_row = jnp.arange(idx.shape[0], dtype=jnp.int32) // jnp.int32(
                dd
            )  # LOCAL channel; the host adds the ch-shard offset per cell
            packed = pack_result_wire(
                idx, lens, types, esn0, freq, arm, chan_row, acc, data,
                overflow, budget,
            )
            return tail_next, packed, busy_next

        return shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(P("ch", None), P(None, "ch", "time"), P("ch")),
            # tail/busy are computed from all-gathered inputs and are
            # identical on every time shard; packed results concatenate in
            # (ch, time) cell order
            out_specs=(P("ch", None), P(("ch", "time")), P("ch")),
            check_vma=False,
        )

    # -------------------------------------------------------------------- io

    def _to_device_planes(self, planes_np: np.ndarray) -> jax.Array:
        # each device receives only its (ch, time) slice of the wire block
        return jax.device_put(planes_np, self._wire_sharding)

    def _materialize(self, inflight) -> list[DecodedPacket]:
        outs, abs_offset = inflight
        max_len = self.rx.config.max_payload_len
        rows_loc = self.c_loc * self.rx.config.max_detections
        k = wire_slots(rows_loc, self.result_budget)
        cell_bytes = wire_bytes(rows_loc, self.result_budget, max_len)
        packed = np.asarray(outs[1]).reshape(
            self.c_shards, self.t_shards, cell_bytes
        )
        out: list[DecodedPacket] = []
        det_ovf = budget_ovf = False
        for cs in range(self.c_shards):
            for ts in range(self.t_shards):
                slots, d_ovf, b_ovf = unpack_result_wire(
                    packed[cs, ts], k, max_len
                )
                det_ovf |= bool(d_ovf)
                budget_ovf |= bool(b_ovf)
                for i in np.nonzero(slots["accepted"])[0]:
                    n = int(slots["length"][i])
                    out.append(
                        DecodedPacket(
                            data=slots["data"][i, :n].copy(),
                            index=int(slots["index"][i]) + abs_offset,
                            packet_type=int(slots["type"][i]),
                            esn0_db=float(slots["esn0"][i]),
                            channel=cs * self.c_loc
                            + int(slots["channel"][i]),
                            freq=float(slots["freq"][i]),
                            arm=int(slots["arm"][i]),
                        )
                    )
                    if self.log:
                        _log_packet(out[-1])
        _flag_overflows(self, det_ovf, budget_ovf)
        return out
