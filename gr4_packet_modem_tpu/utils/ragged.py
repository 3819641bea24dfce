"""Ragged packet batches: the batched equivalent of the reference's ``Pdu<T>``.

The reference moves whole packets between blocks as ``Pdu<T> = {data, tags}``
items (pdu.hpp:14-19). Here a batch of packets is a dense padded array
``[B, max_len]`` plus a length vector ``[B]`` (and any per-packet metadata as
additional ``[B]``-shaped fields). All per-packet DSP is vectorized over the
batch dimension; ragged concatenation into a contiguous stream is a parallel
searchsorted-gather instead of a scheduler copy loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["PacketBatch", "ragged_concat", "ragged_concat_lengths", "mask_from_lengths"]


@jax.tree_util.register_pytree_node_class
@dataclass
class PacketBatch:
    """Dense ragged batch of packets.

    data: ``[B, max_len]`` payload items (uint8 bytes in the byte domain,
    complex64 in the symbol/sample domains).
    lengths: int32 ``[B]`` valid item count per row.
    types: int32 ``[B]`` PacketType per row (USER_DATA/IDLE).
    """

    data: jax.Array
    lengths: jax.Array
    types: jax.Array | None = None

    def tree_flatten(self):
        return (self.data, self.lengths, self.types), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def batch(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    @classmethod
    def from_list(cls, packets, max_len=None, dtype=np.uint8, types=None):
        """Build from a list of 1-D arrays (host-side helper)."""
        packets = [np.asarray(p) for p in packets]
        ml = max_len or max((p.size for p in packets), default=0)
        data = np.zeros((len(packets), ml), dtype=dtype)
        lens = np.zeros(len(packets), dtype=np.int32)
        for i, p in enumerate(packets):
            data[i, : p.size] = p
            lens[i] = p.size
        t = np.zeros(len(packets), dtype=np.int32) if types is None else np.asarray(
            types, dtype=np.int32
        )
        return cls(jnp.asarray(data), jnp.asarray(lens), jnp.asarray(t))

    def to_list(self):
        data = np.asarray(self.data)
        lens = np.asarray(self.lengths)
        return [data[i, : lens[i]] for i in range(data.shape[0])]


def mask_from_lengths(lengths: jax.Array, max_len: int) -> jax.Array:
    """Boolean validity mask ``[B, max_len]`` from a length vector."""
    return jnp.arange(max_len, dtype=jnp.int32)[None, :] < lengths[:, None]


def ragged_concat(
    data: jax.Array, lengths: jax.Array, out_len: int, fill=0
) -> tuple[jax.Array, jax.Array]:
    """Concatenate the valid prefixes of the rows of ``data`` into one vector.

    Returns ``(out [out_len], total_len)`` where entries past ``total_len``
    are ``fill``. Fully parallel: each output position finds its source row
    with a searchsorted over the row-start offsets.
    """
    lengths = lengths.astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(lengths)])
    total = starts[-1]
    pos = jnp.arange(out_len, dtype=jnp.int32)
    row = jnp.clip(
        jnp.searchsorted(starts, pos, side="right").astype(jnp.int32) - 1,
        0,
        data.shape[0] - 1,
    )
    off = pos - starts[row]
    from .cplx import cgather

    vals = cgather(data, row, jnp.clip(off, 0, data.shape[1] - 1))
    in_range = pos < total
    if jnp.iscomplexobj(data):
        # mask by multiply (real mask times complex values)
        out = vals * in_range.astype(jnp.float32)
        if fill != 0:
            out = out + jnp.asarray(fill, data.dtype) * (
                1.0 - in_range.astype(jnp.float32)
            )
    else:
        out = jnp.where(in_range, vals, jnp.asarray(fill, dtype=data.dtype))
    return out, total


def ragged_concat_lengths(lengths: jax.Array) -> jax.Array:
    """Start offset of each row in the concatenated stream."""
    lengths = lengths.astype(jnp.int32)
    return jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(lengths)])[:-1]
