"""TX chain tests: batched transmitter vs the sequential host reference."""

import jax.numpy as jnp
import numpy as np

import reference_impl as ref
from gr4_packet_modem_tpu.models.transmitter import Transmitter, TxConfig
from gr4_packet_modem_tpu.utils import constants as C
from gr4_packet_modem_tpu.utils.ragged import PacketBatch, ragged_concat


def _random_packets(rng, lengths):
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in lengths]


class TestBurstMode:
    def test_matches_reference_samples(self):
        rng = np.random.default_rng(10)
        lengths = [10, 25, 100, 1, 64]
        payloads = _random_packets(rng, lengths)
        tx = Transmitter(TxConfig(max_payload_len=128))
        batch = PacketBatch.from_list(payloads, max_len=128)
        samples, sample_lens = tx.modulate_bursts(batch)
        samples = np.asarray(samples)
        sample_lens = np.asarray(sample_lens)
        for i, p in enumerate(payloads):
            expected = ref.burst_samples(p, packet_index=i)
            assert sample_lens[i] == expected.size
            np.testing.assert_allclose(
                samples[i, : expected.size], expected, atol=2e-5
            )
            # padding is zeroed
            assert not samples[i, expected.size :].any()

    def test_burst_geometry(self):
        tx = Transmitter(TxConfig(max_payload_len=64))
        batch = PacketBatch.from_list([np.zeros(10, np.uint8)], max_len=64)
        _, lens = tx.modulate_bursts(batch)
        assert int(lens[0]) == C.burst_symbols(10) * 4

    def test_glfsr_offset(self):
        # packet index affects only the ramp-down section
        rng = np.random.default_rng(11)
        p = rng.integers(0, 256, 20, dtype=np.uint8)
        tx = Transmitter(TxConfig(max_payload_len=32))
        batch = PacketBatch.from_list([p], max_len=32)
        s0, _ = tx.modulate_bursts(batch, packet_index0=0)
        s7, _ = tx.modulate_bursts(batch, packet_index0=7)
        expected = ref.burst_samples(p, packet_index=7)
        np.testing.assert_allclose(
            np.asarray(s7)[0, : expected.size], expected, atol=2e-5
        )
        assert np.abs(np.asarray(s0) - np.asarray(s7)).max() > 1e-3

    def test_idle_packet_type_in_header(self):
        tx = Transmitter(TxConfig(max_payload_len=32))
        p = np.zeros(16, np.uint8)
        b_user = PacketBatch.from_list([p], max_len=32, types=[0])
        b_idle = PacketBatch.from_list([p], max_len=32, types=[1])
        su, _ = tx.modulate_bursts(b_user)
        si, _ = tx.modulate_bursts(b_idle)
        expected_idle = ref.burst_samples(p, 0, packet_type=C.PacketType.IDLE)
        np.testing.assert_allclose(
            np.asarray(si)[0, : expected_idle.size], expected_idle, atol=2e-5
        )
        assert np.abs(np.asarray(su) - np.asarray(si)).max() > 1e-3


class TestStreamMode:
    def test_matches_reference_stream(self):
        rng = np.random.default_rng(12)
        lengths = [10, 25, 3, 40]
        payloads = _random_packets(rng, lengths)
        tx = Transmitter(TxConfig(max_payload_len=64, stream_mode=True))
        batch = PacketBatch.from_list(payloads, max_len=64)
        out_syms = sum(C.stream_symbols(n) for n in lengths)
        carry, samples, total = tx.modulate_stream(batch, out_syms)
        expected = ref.stream_samples(payloads)
        assert int(total) == expected.size
        np.testing.assert_allclose(
            np.asarray(samples)[: expected.size], expected, atol=2e-5
        )

    def test_stream_carry_across_batches(self):
        rng = np.random.default_rng(13)
        payloads = _random_packets(rng, [12, 30, 7, 21])
        tx = Transmitter(TxConfig(max_payload_len=64, stream_mode=True))
        expected = ref.stream_samples(payloads)
        b1 = PacketBatch.from_list(payloads[:2], max_len=64)
        b2 = PacketBatch.from_list(payloads[2:], max_len=64)
        n1 = sum(C.stream_symbols(len(p)) for p in payloads[:2])
        n2 = sum(C.stream_symbols(len(p)) for p in payloads[2:])
        carry, s1, t1 = tx.modulate_stream(b1, n1)
        carry, s2, t2 = tx.modulate_stream(b2, n2, carry)
        got = np.concatenate([np.asarray(s1), np.asarray(s2)])
        np.testing.assert_allclose(got, expected, atol=2e-5)


class TestRaggedConcat:
    def test_basic(self):
        data = jnp.asarray([[1, 2, 3, 0], [4, 0, 0, 0], [5, 6, 0, 0]], jnp.int32)
        lens = jnp.asarray([3, 1, 2], jnp.int32)
        out, total = ragged_concat(data, lens, 8)
        assert int(total) == 6
        np.testing.assert_array_equal(np.asarray(out), [1, 2, 3, 4, 5, 6, 0, 0])
