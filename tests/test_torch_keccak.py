"""The port's batched Keccak-256 (khipu_tpu_torch.ops) against the JAX
package: the plain PyTorch sponges on the CPU must give exactly the bytes
of the jnp sponge and of the scalar oracle. Kernels K1 and K1f run only
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
    hash_padded,
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
    got = hash_padded(torch.from_numpy(rows.copy())).numpy()
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
