#!/usr/bin/env python3
"""CRC demo: the generic host CRC, the batched device engine, and the
append/check pair with endianness/skip options.

Mirrors the reference examples crc.cpp / crc_check.cpp /
crc_append_missing_tags.cpp (Crc class + CrcAppend/CrcCheck blocks).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gr4_packet_modem_tpu.utils.platform import setup as _pm_setup

_pm_setup()  # PM_PLATFORM backend override + persistent compile cache

import numpy as np
import jax.numpy as jnp

from gr4_packet_modem_tpu.ops.crc import (
    BatchedCrcAppend,
    BatchedCrcCheck,
    CrcRef,
    make_crc32_engine,
)

data = np.frombuffer(b"123456789", np.uint8)

# generic host CRC, parameter-compatible with the reference Crc class
for name, kw in [
    ("CRC-32", {}),
    ("CRC-16/CCITT", dict(num_bits=16, poly=0x1021, initial_value=0xFFFF,
                          final_xor=0x0000, input_reflected=False,
                          result_reflected=False)),
]:
    print(f"{name}: 0x{CrcRef(**kw).compute(data):08X}")

# batched engine: many packets, one GF(2)-matmul pass
engine = make_crc32_engine(max_len=32)
batch = jnp.zeros((3, 32), jnp.uint8).at[:, :9].set(jnp.asarray(data))
lengths = jnp.asarray([9, 9, 5], jnp.int32)
print("batched CRC-32:", [hex(int(v)) for v in engine.compute(batch, lengths)])

# append -> corrupt one packet -> check
app = BatchedCrcAppend(max_len=32)
with_crc, new_lens = app.append(batch, lengths)
with_crc = with_crc.at[1, 3].add(1)  # corrupt packet 1
chk = BatchedCrcCheck(max_len=32 + 4)
ok, _stripped, _lens = chk.check(with_crc, new_lens)
print("crc_ok after corrupting packet 1:", np.asarray(ok).tolist())
assert np.asarray(ok).tolist() == [True, False, True]
