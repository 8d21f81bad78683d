"""The port's batched Keccak-256 (khipu_tpu_torch.ops) against the JAX
package: the plain PyTorch sponges on the CPU must give exactly the bytes
of the jnp sponge and of the scalar oracle. Kernels K1r and K1f run only
on the card; ``chip_smoke.py`` holds them against the same plain
versions. Tolerance: exact bytes."""

import numpy as np
import pytest
import torch

from khipu_tpu.base.crypto.keccak import keccak256
from khipu_tpu.ops import keccak_jnp
from khipu_tpu_torch.base.keccak import keccak256_py
from khipu_tpu_torch.ops import keccak_torch
from khipu_tpu_torch.ops.keccak import (
    stage_ragged,
    keccak256_batch,
    keccak256_device_fixed,
    keccak256_fixed,
)

# rate-class edges: 0..5 rate blocks, both sides of each boundary
EDGES = (0, 1, 31, 32, 135, 136, 137, 271, 272, 543, 544, 576)


def _messages(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


# The jnp sponge compiles once per rate class (seconds each on the CPU),
# so it is compared on the 1- and 2-block classes, as the JAX package's
# own tests run it; every class is compared with the scalar oracles.
JNP_EDGES = tuple(n for n in EDGES if n < 272)


def test_rate_class_edges_vs_oracles_and_jnp():
    msgs = _messages(1, EDGES)
    got = keccak256_batch(msgs, device="cpu")
    assert got == [keccak256(m) for m in msgs]
    assert got == [keccak256_py(m) for m in msgs]
    jnp_msgs = msgs[: len(JNP_EDGES)]
    assert got[: len(JNP_EDGES)] == keccak_jnp.keccak256_batch_jnp(jnp_msgs)


def test_mixed_batch_keeps_input_order():
    rng = np.random.default_rng(2)
    lengths = rng.permutation(np.repeat(EDGES, 2))
    msgs = _messages(3, lengths)
    got = keccak256_batch(msgs, device="cpu")
    assert got == [keccak256(m) for m in msgs]
    jnp_msgs = [m for m in msgs if len(m) < 272]
    assert [g for g, m in zip(got, msgs) if len(m) < 272] == (
        keccak_jnp.keccak256_batch_jnp(jnp_msgs)
    )


@pytest.mark.parametrize("nblocks", [1, 2])
def test_absorb_padded_vs_hash_padded_u8(nblocks):
    """The plain sponge on padded rows against the JAX package's shared
    padded-row formulation (the one its fixpoint uses)."""
    rng = np.random.default_rng(10 + nblocks)
    lengths = rng.integers((nblocks - 1) * 136, nblocks * 136, 16)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]
    rows = keccak_torch.pad_to_words(msgs, nblocks).view(np.uint8)
    ref = np.asarray(keccak_jnp.hash_padded_u8(rows, nblocks))
    got = keccak_torch.absorb_padded(torch.from_numpy(rows.copy())).numpy()
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("length", [20, 135, 576])
def test_keccak256_fixed_vs_oracle(length):
    data = np.random.default_rng(length).integers(
        0, 256, (7, length), dtype=np.uint8
    )
    out = keccak256_fixed(data, device="cpu")
    assert out.shape == (7, 32) and out.dtype == torch.uint8
    for i in range(7):
        assert out[i].numpy().tobytes() == keccak256(data[i].tobytes())


def test_pad_xors_0x81_at_135():
    row = keccak_torch.pad_to_words([bytes(135)], 1).view(np.uint8)[0]
    assert row[135] == 0x81 and row[:135].sum() == 0


@pytest.mark.parametrize("nblocks", [1, 3])
def test_copied_helpers_match_reference(nblocks):
    msgs = _messages(5 + nblocks, [(nblocks - 1) * 136 + k for k in (0, 7, 135)])
    np.testing.assert_array_equal(
        keccak_torch.pad_to_words(msgs, nblocks),
        keccak_jnp.pad_to_words(msgs, nblocks),
    )
    with pytest.raises(ValueError):
        keccak_torch.pad_to_words([b"x" * 300], nblocks if nblocks != 3 else 1)


def test_empty_batch():
    assert keccak256_batch([], device="cpu") == []
    assert keccak_torch.keccak256_batch_plain([]) == []


# K1f's pad edges: empty, unaligned, 20 B address and 32 B slot keys, both
# pad bits in one byte (135), a block of padding alone (136, 272)
K1F_EDGES = (0, 1, 20, 32, 135, 136, 137, 271, 272)


@pytest.mark.parametrize("length", K1F_EDGES)
def test_device_fixed_vs_jnp_route(length):
    """``keccak256_device_fixed`` on the CPU (K1f's plain version) against
    the JAX package's CPU route: its own host pad, then the jnp sponge.
    u32 word input gives the same digests as the bytes."""
    data = np.random.default_rng(100 + length).integers(
        0, 256, (16, length), dtype=np.uint8
    )
    nblocks = length // 136 + 1
    padded = keccak_jnp.pad_to_words(
        [row.tobytes() for row in data], nblocks
    ).view(np.uint8)
    ref = np.asarray(keccak_jnp.hash_padded_u8(padded, nblocks))
    got = keccak256_device_fixed(data, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (16, 32)
    assert got.numpy().tobytes() == ref.tobytes()
    assert torch.equal(keccak_torch.absorb_fixed(torch.from_numpy(data)), got)
    if length and length % 4 == 0:
        words = torch.from_numpy(data.copy()).view(torch.int32)
        assert torch.equal(keccak256_device_fixed(words, device="cpu"), got)
        assert torch.equal(
            keccak256_device_fixed(data.view("<u4"), device="cpu"), got
        )


def test_pad_fixed_edges():
    for length, lead in ((135, 0x81), (0, 0x01)):
        row = keccak_torch.pad_fixed(torch.zeros((1, length), dtype=torch.uint8))[0]
        assert row.shape[0] == 136 and int(row[length]) == lead
    row = keccak_torch.pad_fixed(torch.zeros((1, 136), dtype=torch.uint8))[0]
    assert row.shape[0] == 272 and int(row[136]) == 1 and int(row[271]) == 0x80


# K1r's pad and rate-class edges: empty, both pad bits in one byte (135),
# a block of padding alone (136, 272, 544), one past each edge
RAGGED_EDGES = (0, 1, 135, 136, 137, 271, 272, 543, 544)


def test_ragged_edges_vs_jnp_and_oracles():
    """``keccak256_batch`` on the CPU runs K1r's plain version; at the
    class edges it gives the jnp sponge's bytes (the 1- and 2-block
    classes the other tests compile) and the scalar oracles'."""
    msgs = _messages(20, RAGGED_EDGES)
    got = keccak256_batch(msgs, device="cpu")
    assert got == [keccak256(m) for m in msgs]
    assert got == [keccak256_py(m) for m in msgs]
    short = [m for m in msgs if len(m) < 272]
    assert [g for g, m in zip(got, msgs) if len(m) < 272] == (
        keccak_jnp.keccak256_batch_jnp(short)
    )


def test_ragged_mixed_batch_with_code_blobs_keeps_input_order():
    """A seeded batch shaped like a fast-sync fetch: leaves, branches,
    2,048 B code blobs (16 rate blocks) and the edges, shuffled."""
    rng = np.random.default_rng(21)
    lengths = np.concatenate([
        rng.integers(0, 600, 40), np.full(3, 2048), RAGGED_EDGES,
    ])
    msgs = _messages(22, rng.permutation(lengths))
    got = keccak256_batch(msgs, device="cpu")
    assert got == [keccak256(m) for m in msgs]
    assert keccak_torch.keccak256_batch_plain(msgs) == got  # bucketed path
    short = [m for m in msgs if len(m) < 272]
    assert [g for g, m in zip(got, msgs) if len(m) < 272] == (
        keccak_jnp.keccak256_batch_jnp(short)
    )


def test_batch_is_one_ragged_call(monkeypatch):
    """However many rate classes a batch spans, the CPU path makes one
    ``absorb_ragged`` call on one packed blob and pads nothing itself."""
    calls = []
    real = keccak_torch.absorb_ragged

    def spy(blob, offsets, lengths):
        calls.append(int(lengths.numel()))
        return real(blob, offsets, lengths)

    monkeypatch.setattr(keccak_torch, "absorb_ragged", spy)
    monkeypatch.setattr(keccak_torch, "pad_to_words", None)
    msgs = _messages(23, (3, 140, 300, 2048, 0))
    assert keccak256_batch(msgs, device="cpu") == [keccak256(m) for m in msgs]
    assert calls == [5]


@pytest.mark.parametrize("nblocks", [1, 2, 3, 16])
def test_absorb_ragged_vs_absorb_padded(nblocks):
    """K1r's plain version on packed messages against the padded-row
    sponge on the same messages padded on the host."""
    rng = np.random.default_rng(30 + nblocks)
    lengths = rng.integers((nblocks - 1) * 136, nblocks * 136, 9)
    msgs = _messages(31 + nblocks, lengths)
    blob, offsets, lens = keccak_torch.pack_ragged(msgs)
    got = keccak_torch.absorb_ragged(
        torch.from_numpy(blob), torch.from_numpy(offsets), torch.from_numpy(lens)
    )
    rows = keccak_torch.pad_to_words(msgs, nblocks).view(np.uint8)
    assert torch.equal(got, keccak_torch.absorb_padded(torch.from_numpy(rows.copy())))


def test_pack_ragged_layout():
    msgs = [b"", b"a" * 5, b"b" * 8, b"c" * 137, b""]
    blob, offsets, lengths = keccak_torch.pack_ragged(msgs)
    assert offsets.dtype == np.int32 and lengths.dtype == np.int32
    assert lengths.tolist() == [0, 5, 8, 137, 0]
    assert offsets.tolist() == [0, 0, 8, 16, 160]
    assert (offsets % 8 == 0).all() and blob.size == 160
    for m, o in zip(msgs, offsets):
        assert blob[o : o + len(m)].tobytes() == m
    assert not blob[5:8].any() and not blob[153:160].any()  # zero gaps
    assert blob.flags.writeable


def test_pack_ragged_empty_batch():
    blob, offsets, lengths = keccak_torch.pack_ragged([])
    assert blob.size == 0 and offsets.size == 0 and lengths.size == 0
    out = keccak_torch.absorb_ragged(
        torch.from_numpy(blob), torch.from_numpy(offsets), torch.from_numpy(lengths)
    )
    assert out.shape == (0, 32)


def test_absorb_ragged_blob_of_empty_messages():
    """Empty messages only: the blob has no bytes and every digest is
    keccak256(b"")."""
    blob, offsets, lengths = keccak_torch.pack_ragged([b"", b""])
    out = keccak_torch.absorb_ragged(
        torch.from_numpy(blob), torch.from_numpy(offsets), torch.from_numpy(lengths)
    )
    assert [out[i].numpy().tobytes() for i in range(2)] == [keccak256(b"")] * 2


def test_stage_ragged_is_one_buffer():
    """The card's path uploads header and blob as one buffer: the header
    (offsets, then lengths) first, the blob 8-byte aligned right after."""
    msgs = [b"abc", b"", b"x" * 300]
    blob, offsets, lengths = keccak_torch.pack_ragged(msgs)
    blob_t, header = stage_ragged(blob, offsets, lengths, torch.device("cpu"))
    assert header.dtype == torch.int32
    assert header.tolist() == offsets.tolist() + lengths.tolist()
    assert blob_t.numpy().tobytes() == blob.tobytes()
    assert blob_t.data_ptr() == header.data_ptr() + 8 * len(msgs)
    got = keccak_torch.absorb_ragged(blob_t, header[:3], header[3:])
    assert [got[i].numpy().tobytes() for i in range(3)] == [
        keccak256(m) for m in msgs]
