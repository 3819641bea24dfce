"""Lane-packed bank decode (Receiver.decode_bank) vs the per-channel path.

Round 2's receiver vmapped the decode passes per channel, serializing the
Pallas kernels into underfilled instances; round 3 packs all channels'
detections into one flat batch. This test pins the restructure to the
per-channel reference: identical accepted sets, payload bytes, lengths and
header fields across channels with different CFOs and staggered packets —
including that in-packet suppression stays per-channel (a packet on channel
0 must not suppress a detection at an overlapping index on channel 1).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gr4_packet_modem_tpu.models.channel import awgn, rotate
from gr4_packet_modem_tpu.models.receiver import Receiver, RxConfig
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat

CFG = RxConfig(max_payload_len=128, max_detections=8, freq_bins=1)


@pytest.fixture(scope="module")
def bank_signal():
    tx = Transmitter(TxConfig(max_payload_len=128))
    rng = np.random.default_rng(42)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in (50, 96, 128)]
    batch = PacketBatch.from_list(payloads, max_len=128)
    s, l = tx.modulate_bursts(batch)
    stream, _ = ragged_concat(s, l, int(np.asarray(l).sum()))
    burst = np.asarray(stream)
    channels = 3
    n = 16384
    rx = Receiver(CFG)
    fp, pt = rx.front_pad, rx.pad_tail()
    x = np.zeros((channels, fp + n + pt), np.complex64)
    for c in range(channels):
        sig = np.zeros(n, np.complex64)
        # stagger packets so the same index ranges overlap across channels
        sig[37 + 401 * c : 37 + 401 * c + burst.size] = burst
        sig = np.asarray(rotate(jnp.asarray(sig), 0.002 * (c - 1)))
        sig = np.asarray(awgn(jax.random.PRNGKey(c), jnp.asarray(sig), 0.02))
        x[c, fp : fp + n] = sig
    return rx, x, payloads


def _per_channel(rx, x):
    outs = []
    for c in range(x.shape[0]):
        xc = jnp.asarray(x[c])
        det = rx.acquirer.acquire(xc)
        hdr, _ = rx.decode_headers(xc, det)
        keep = rx.filter_detections(det, hdr)
        res = rx.decode_payloads(xc, det, hdr, keep)
        outs.append((det, hdr, res, keep))
    return outs


def test_bank_matches_per_channel(bank_signal):
    rx, x, payloads = bank_signal
    ref = _per_channel(rx, x)
    detf, hdr, res, keep = rx.bank_step(jnp.asarray(x))
    dd = CFG.max_detections
    for c, (det_c, hdr_c, res_c, keep_c) in enumerate(ref):
        rows = slice(c * dd, (c + 1) * dd)
        np.testing.assert_array_equal(
            np.asarray(detf.index[rows]), np.asarray(det_c.index)
        )
        np.testing.assert_array_equal(
            np.asarray(detf.valid[rows]), np.asarray(det_c.valid)
        )
        np.testing.assert_array_equal(
            np.asarray(keep[rows]), np.asarray(keep_c)
        )
        np.testing.assert_array_equal(
            np.asarray(res.accepted[rows]), np.asarray(res_c.accepted)
        )
        # decode outputs compared on VALID rows only: invalid slots decode
        # garbage extractions whose f32 accumulation grouping legitimately
        # differs between the [2D]- and [2CD]-group conv compilations
        v = np.asarray(det_c.valid)
        np.testing.assert_array_equal(
            np.asarray(hdr.packet_length[rows])[v],
            np.asarray(hdr_c.packet_length)[v],
        )
        np.testing.assert_array_equal(
            np.asarray(res.lengths[rows])[v], np.asarray(res_c.lengths)[v]
        )
        np.testing.assert_array_equal(
            np.asarray(res.data[rows])[v], np.asarray(res_c.data)[v]
        )
        # loop state after the header must match closely (same recursion)
        np.testing.assert_allclose(
            np.asarray(hdr.phase[rows])[v],
            np.asarray(hdr_c.phase)[v],
            atol=1e-5,
        )


def test_bank_decodes_all_packets(bank_signal):
    rx, x, payloads = bank_signal
    _, _, res, _ = rx.bank_step(jnp.asarray(x))
    acc = np.asarray(res.accepted)
    data = np.asarray(res.data)
    lens = np.asarray(res.lengths)
    assert int(acc.sum()) == x.shape[0] * len(payloads)
    # every decoded payload byte-exact
    good = 0
    for i in np.nonzero(acc)[0]:
        for p in payloads:
            if lens[i] == p.size and np.array_equal(data[i, : p.size], p):
                good += 1
                break
    assert good == int(acc.sum())


def test_bank_group_pipelining_matches_monolithic(bank_signal):
    """Channel-group pipelining (bank_step group=N, a lax.map over channel
    groups bounding the working set) must
    produce the identical flattened [C*D] result rows as the monolithic
    program."""
    rx, x, payloads = bank_signal
    xj = jnp.asarray(x)
    mono = rx.bank_step(xj, 0)
    grouped = rx.bank_step(xj, 1)  # 3 channels -> 3 groups of 1
    for m, g in zip(jax.tree.leaves(mono), jax.tree.leaves(grouped)):
        assert m.shape == g.shape
    # exact-row comparisons on the decision outputs
    np.testing.assert_array_equal(
        np.asarray(mono[0].index), np.asarray(grouped[0].index)
    )
    np.testing.assert_array_equal(
        np.asarray(mono[2].accepted), np.asarray(grouped[2].accepted)
    )
    v = np.asarray(mono[0].valid)
    np.testing.assert_array_equal(
        np.asarray(mono[2].data)[v], np.asarray(grouped[2].data)[v]
    )
    np.testing.assert_array_equal(
        np.asarray(mono[3]), np.asarray(grouped[3])
    )


def test_bank_suppression_is_per_channel():
    """Two channels with packets at overlapping indices: both must decode
    (cross-channel suppression would drop one)."""
    tx = Transmitter(TxConfig(max_payload_len=128))
    rng = np.random.default_rng(1)
    p = rng.integers(0, 256, 64, dtype=np.uint8)
    batch = PacketBatch.from_list([p], max_len=128)
    s, l = tx.modulate_bursts(batch)
    burst = np.asarray(s[0][: int(np.asarray(l)[0])])
    rx = Receiver(CFG)
    fp, pt = rx.front_pad, rx.pad_tail()
    n = 8192
    x = np.zeros((2, fp + n + pt), np.complex64)
    # same position on ch0, shifted by less than a packet extent on ch1
    x[0, fp + 100 : fp + 100 + burst.size] = burst
    x[1, fp + 140 : fp + 140 + burst.size] = burst
    _, _, res, _ = rx.bank_step(jnp.asarray(x))
    assert int(np.asarray(res.accepted).sum()) == 2
