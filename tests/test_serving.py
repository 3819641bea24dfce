"""StreamingShardedBank: host-fed serving on a (ch, time) mesh.

The sharded serving driver must reproduce StreamingBank's guarantees
exactly: every packet decoded exactly once with correct channel attribution
and byte content, across driver block boundaries AND time-shard boundaries,
with in-packet suppression state carried across both (the serving analogue
of apps/packet_transceiver.cpp:99-131 scaled over a device mesh).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from gr4_packet_modem_tpu.models.receiver import RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.parallel.bank import make_mesh
from gr4_packet_modem_tpu.parallel.serving import StreamingShardedBank
from gr4_packet_modem_tpu.runtime.streaming import StreamingBank
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

BLOCK = 4096
CFG = dict(max_payload_len=128, max_detections=4, freq_bins=1)


def _burst_stream(payloads, seed_phase=0.0):
    tx = Transmitter(TxConfig(max_payload_len=128))
    batch = PacketBatch.from_list(payloads, max_len=128)
    s, l = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
    return (np.asarray(stream) * np.exp(1j * seed_phase)).astype(np.complex64)


def _stimulus(channels, seed=11):
    """Multi-block per-channel packet streams with staggered offsets so
    packets straddle driver block AND time-shard boundaries."""
    rng = np.random.default_rng(seed)
    ch_payloads = [
        [rng.integers(0, 256, n, dtype=np.uint8)
         for n in rng.integers(20, 128, 4)]
        for _ in range(channels)
    ]
    streams = [
        _burst_stream(p, 0.3 * c) for c, p in enumerate(ch_payloads)
    ]
    total = max(s.size for s in streams) + 2 * BLOCK
    x = np.zeros((channels, total), np.complex64)
    for c, s in enumerate(streams):
        off = 150 + 731 * c  # straddle boundaries differently per channel
        x[c, off : off + s.size] = s
    return x, ch_payloads


def _packet_key(p):
    return (p.channel, p.index, p.data.tobytes(), p.arm)


def test_sharded_bank_matches_streaming_bank():
    """(4 ch x 2 time) mesh decode == single-device StreamingBank decode,
    packet-for-packet (channel, absolute index, bytes, timing arm)."""
    channels = 4
    x, ch_payloads = _stimulus(channels)

    ref = StreamingBank(RxConfig(**CFG), channels=channels, block=BLOCK,
                        group=0)
    ref_pkts = ref.process(x) + ref.flush()
    assert ref.overflow_blocks == 0
    # every payload decoded exactly once in the reference run
    assert len(ref_pkts) == sum(len(p) for p in ch_payloads)

    mesh = make_mesh(8, time_shards=2)  # (4 ch, 2 time)
    bank = StreamingShardedBank(
        mesh, RxConfig(**CFG), channels=channels, block=BLOCK, group=0
    )
    pkts = bank.process(x) + bank.flush()
    assert bank.overflow_blocks == 0 and bank.budget_overflow_blocks == 0
    assert sorted(map(_packet_key, pkts)) == sorted(
        map(_packet_key, ref_pkts)
    )


def test_sharded_bank_degenerate_mesh_parity():
    """The 1x1 mesh is the single-chip case and must match StreamingBank."""
    channels = 2
    x, _ = _stimulus(channels, seed=12)
    ref = StreamingBank(RxConfig(**CFG), channels=channels, block=BLOCK,
                        group=0)
    ref_pkts = ref.process(x) + ref.flush()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("ch", "time"))
    bank = StreamingShardedBank(
        mesh, RxConfig(**CFG), channels=channels, block=BLOCK, group=0
    )
    pkts = bank.process(x) + bank.flush()
    assert sorted(map(_packet_key, pkts)) == sorted(
        map(_packet_key, ref_pkts)
    )
    assert len(ref_pkts) > 0


def test_sharded_bank_compacted_wire_parity():
    """Per-cell result compaction must not change the decoded packet set
    when the budget covers the per-cell accepted count."""
    channels = 4
    x, ch_payloads = _stimulus(channels, seed=13)
    mesh = make_mesh(8, time_shards=2)
    results = {}
    for budget in (None, 3):
        bank = StreamingShardedBank(
            mesh, RxConfig(**CFG), channels=channels, block=BLOCK, group=0,
            result_budget=budget,
        )
        pkts = bank.process(x) + bank.flush()
        assert bank.budget_overflow_blocks == 0, f"budget={budget}"
        results[budget] = sorted(map(_packet_key, pkts))
    assert results[None] == results[3]
    assert len(results[None]) == sum(len(p) for p in ch_payloads)


def test_sharded_bank_group_pipelining_matches_monolithic():
    """Channel-group pipelining inside each device's local step must not
    change results (the chain all-gather inside the lax.map body is
    collective-matched across shards)."""
    channels = 8  # (2 ch shards x 2 time shards) -> C_loc = 4
    x, _ = _stimulus(channels, seed=15)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("ch", "time"))
    results = {}
    for group in (0, 2):
        bank = StreamingShardedBank(
            mesh, RxConfig(**CFG), channels=channels, block=BLOCK,
            group=group,
        )
        pkts = bank.process(x) + bank.flush()
        results[group] = sorted(map(_packet_key, pkts))
    assert len(results[0]) > 0
    assert results[0] == results[2]


@pytest.mark.parametrize("xfer", ["int8", "int4"])
def test_sharded_bank_quantized_wire(xfer):
    """Reduced-precision h2d wires (int8, packed int4) stay decode-lossless
    through the mesh-sharded upload + on-mesh reassembly (the bench parity
    gate)."""
    import jax.numpy as jnp

    channels = 4
    x, ch_payloads = _stimulus(channels, seed=14)
    mesh = make_mesh(8, time_shards=2)
    bank = StreamingShardedBank(
        mesh, RxConfig(**CFG), channels=channels, block=BLOCK, group=0,
        transfer_dtype=jnp.int8 if xfer == "int8" else "int4",
        result_budget=4,
    )
    pkts = bank.process(x) + bank.flush()
    assert bank.overflow_blocks == 0 and bank.budget_overflow_blocks == 0
    by_ch = {c: [] for c in range(channels)}
    for p in sorted(pkts, key=lambda p: p.index):
        by_ch[p.channel].append(p.data)
    for c in range(channels):
        assert len(by_ch[c]) == len(ch_payloads[c])
        for got, exp in zip(by_ch[c], ch_payloads[c]):
            np.testing.assert_array_equal(got, exp)
