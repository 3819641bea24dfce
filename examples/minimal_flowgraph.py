#!/usr/bin/env python3
"""The smallest pipeline: vector source -> scramble -> descramble -> sink.

Mirrors the reference examples minimal_flowgraph.cpp and
python/examples/minimal_flowgraph.py (emplaceBlock by name + connect + run);
here graphs are plain Python composition over batched arrays, and the
registry provides reference-name lookup (docs/DESIGN.md §graph model).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()  # PM_PLATFORM backend override + persistent compile cache

import numpy as np
import jax.numpy as jnp

from gr4_packet_modem_tpu import registry
from gr4_packet_modem_tpu.ops.packing import bytes_to_bits, pack_bits

vector_source = registry.resolve("VectorSource")  # PacketBatch.from_list
scramble = registry.resolve("AdditiveScrambler").scramble_bits

batch = vector_source([np.frombuffer(b"hello gr4", np.uint8),
                       np.frombuffer(b"jax modem", np.uint8)])
bits = bytes_to_bits(jnp.asarray(batch.data))
once = scramble(bits)
twice = scramble(once)  # the CCSDS additive scrambler is an involution
out = np.asarray(pack_bits(twice, 8)).astype(np.uint8)
for row, n in zip(out, np.asarray(batch.lengths)):
    print(bytes(row[:n]).decode())
assert bytes(out[0][:9]) == b"hello gr4"
