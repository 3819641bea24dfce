#!/usr/bin/env python3
"""PDU <-> stream domain conversion.

Mirrors the reference's domain-converter examples
(``examples/pdu_to_tagged_stream.cpp``, ``examples/tagged_stream_to_pdu.cpp``,
``examples/pdu_specialization.cpp``): GR4 carries packets either as
``packet_len``-tagged streams or as ``Pdu`` items, with converter blocks
between the two. The equivalents here are explicit and batched:

- the Pdu domain is :class:`PacketBatch` (dense ``[B, max_len]`` + lengths),
- the tagged-stream domain is a flat item array plus an explicit lengths
  array — the dense replacement for sparse ``packet_len`` tags,
- ``PduToTaggedStream`` == :func:`ragged_concat` (one jittable op),
- ``TaggedStreamToPdu`` == slicing the flat stream back by lengths
  (``StreamToPdu``'s fixed-size chop is the ``reshape`` special case).

Everything here runs under jit on device; the round trip is exact.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()

import jax
import numpy as np

from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

# --- Pdu domain: a ragged batch of byte packets
payloads = [
    np.arange(10, dtype=np.uint8),
    np.arange(50, 80, dtype=np.uint8),
    np.full(5, 0xAB, np.uint8),
]
batch = PacketBatch.from_list(payloads, max_len=32)
print(f"pdu domain: B={batch.batch} max_len={batch.max_len} "
      f"lengths={np.asarray(batch.lengths).tolist()}")

# --- PduToTaggedStream: concatenate valid bytes; lengths ARE the tags
total = int(np.asarray(batch.lengths).sum())
stream, n = jax.jit(
    lambda d, l: ragged_concat(d, l, total)
)(batch.data, batch.lengths)
stream = np.asarray(stream)[: int(n)]
print(f"tagged-stream domain: {stream.size} items, "
      f"len 'tags' {np.asarray(batch.lengths).tolist()}")

# --- TaggedStreamToPdu: chop the flat stream back by the length metadata
offsets = np.concatenate([[0], np.cumsum(np.asarray(batch.lengths))[:-1]])
round_trip = [
    stream[o : o + l]
    for o, l in zip(offsets, np.asarray(batch.lengths))
]
assert all(np.array_equal(a, b) for a, b in zip(round_trip, payloads))
print("round trip Pdu -> stream -> Pdu: exact")

# --- StreamToPdu: the fixed-size chop (stream_to_pdu.hpp) is a reshape
fixed = stream[: (stream.size // 15) * 15].reshape(-1, 15)
print(f"StreamToPdu(15): {fixed.shape[0]} fixed-size PDUs of 15 items")
print("ok")
