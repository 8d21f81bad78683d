"""Kernel K4 of the port's device mirror (``storage/mirror_cuda.py``,
``storage/csrc/mirror.cu``): its launch plan on the CPU, and on the card
its counts against the plain version, ``device_mirror.verify_planes_plain``.

K4 reads a class through TMA tensor maps and walks tiles of 128 rows on a
persistent grid. ``verify_plan`` is the pure part of its wrapper: the
grid, and the rule a tensor map sets (16-byte aligned bases, row strides
a multiple of 4 words, n < 2**31). The card tests cover generic classes
of 1-5 rate blocks and exact lengths whose pad falls anywhere in the last
block (64; 132, where 0x01 and 0x80 share a word; 136, whose last block
is all zero fill; 540; 576), partial and single tiles, row strides wider
than n, a class several times the grid, and a mismatch in each digest
word, in the first and the last row. Counts must equal the plain
version's exactly.

This file imports no JAX, so the card tests run on a machine without it:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_mirror_k4.py``."""

import numpy as np
import pytest
import torch

from khipu_tpu_torch.storage import device_mirror, mirror_cuda

TILE_ROWS = mirror_cuda.TILE_ROWS
LD = 10_485_760  # the snapshot verify's class: 10M rows


@pytest.mark.parametrize("n, cap, grid", [
    (1, 660, 1),
    (127, 660, 1),
    (128, 660, 1),
    (129, 660, 2),
    (660 * 128, 660, 660),
    (660 * 128 + 1, 660, 660),
    (LD, 660, 660),
    (LD, 100_000, LD // 128),
    (2 ** 31 - 1, 660, 660),
])
def test_verify_plan_grid(n, cap, grid):
    """A CTA a tile of 128 rows, and never more CTAs than the card holds."""
    assert mirror_cuda.verify_plan(n, cap, [(0, LD), (1 << 20, LD)]) == grid


@pytest.mark.parametrize("n, cap, maps, why", [
    (0, 660, [(0, LD)], "0 < n"),
    (2 ** 31, 660, [(0, LD)], "n < 2\\*\\*31"),
    (128, 660, [(4, LD)], "aligned"),
    (128, 660, [(0, LD), (8, LD)], "aligned"),
    (128, 660, [(0, LD + 2)], "multiple of 4 words"),
    (128, 660, [(0, LD), (1 << 20, 1)], "multiple of 4 words"),
    (128, 0, [(0, LD)], "fits no CTA"),
])
def test_verify_plan_refuses(n, cap, maps, why):
    """What a tensor map cannot describe raises; there is no other path."""
    with pytest.raises(ValueError, match=why):
        mirror_cuda.verify_plan(n, cap, maps)


def test_verify_plan_takes_every_mirror_class():
    """A mirror class (capacity a multiple of 1,024 rows, fresh buffers)
    and a slice of it from column 0 meet the rule; a slice from another
    column that is not a multiple of 4 does not."""
    resident = torch.zeros((144, 2 * 1024), dtype=torch.int32)
    claimed = torch.zeros((8, 2 * 1024), dtype=torch.int32)
    for cols in (slice(None), slice(0, 5), slice(4, 100)):
        planes, claims = resident[:, cols], claimed[:, cols]
        maps = [(planes.data_ptr(), planes.stride(0)),
                (claims.data_ptr(), claims.stride(0))]
        n = planes.shape[1]
        assert mirror_cuda.verify_plan(n, 660, maps) == -(-n // TILE_ROWS)
    planes = resident[:, 3:]
    with pytest.raises(ValueError, match="aligned"):
        mirror_cuda.verify_plan(planes.shape[1], 660,
                                [(planes.data_ptr(), planes.stride(0))])


def test_verify_planes_refuses_cpu_tensors():
    planes = torch.zeros((34, 128), dtype=torch.int32)
    claims = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mirror_cuda.verify_planes(planes, claims, 1, 34)


# ------------------------------------------------------------ the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


# (nblocks, exact_len): generic classes store padded rows, exact ones
# unpadded rows of exact_len bytes
CLASSES = [(b, None) for b in range(1, 6)] + [
    (length // 136 + 1, length) for length in (64, 132, 136, 540, 576)]
ROWS = [1, 127, 128, 129, 1024 * 1024 + 1000]


def _class(dev, nblocks, exact_len, n, seed):
    """Random word-major planes and their true claims, each a column
    slice from column 0 of a wider buffer (row strides > n, and unequal),
    the columns past n filled with other random words."""
    nwords = (exact_len or nblocks * 136) // 4
    gen = torch.Generator(device=dev).manual_seed(seed)
    ld = -(-n // 1024) * 1024 + 1024
    planes = torch.randint(-2 ** 31, 2 ** 31, (nwords, ld), generator=gen,
                           dtype=torch.int32, device=dev)[:, :n]
    claims = torch.randint(-2 ** 31, 2 ** 31, (8, ld + 4), generator=gen,
                           dtype=torch.int32, device=dev)[:, :n]
    claims.copy_(device_mirror.hash_planes_plain(planes, nblocks, exact_len))
    return planes, claims, nwords


def _k4(planes, claims, nblocks, nwords):
    return int(mirror_cuda.verify_planes(planes, claims, nblocks, nwords).item())


def _copy(claims):
    """A copy of a column slice with the slice's own row stride."""
    rows, n = claims.shape
    out = torch.empty((rows, claims.stride(0)), dtype=claims.dtype,
                      device=claims.device)[:, :n]
    return out.copy_(claims)


@pytest.mark.card
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("nblocks, exact_len", CLASSES)
def test_k4_counts_equal_plain(card, nblocks, exact_len, n):
    planes, claims, nwords = _class(card, nblocks, exact_len, n,
                                    seed=nblocks * 1000 + (exact_len or 0) + n)
    launches = mirror_cuda.VERIFY_LAUNCHES
    assert _k4(planes, claims, nblocks, nwords) == 0
    assert device_mirror.verify_planes_plain(planes, claims, nblocks, exact_len) == 0
    rng = np.random.default_rng(n + nblocks)
    for word in range(8):
        bent = _copy(claims)
        for row in {0, n - 1}:
            bent[word, row] ^= 1 << int(rng.integers(0, 32))
        want = device_mirror.verify_planes_plain(planes, bent, nblocks, exact_len)
        assert want == len({0, n - 1})
        assert _k4(planes, bent, nblocks, nwords) == want, (word, exact_len, n)
    assert mirror_cuda.VERIFY_LAUNCHES == launches + 9


@pytest.mark.card
def test_k4_ctas_walk_several_tiles(card):
    """A clean class of over three times the persistent grid's tiles,
    then one bad row in each of a CTA's tiles and in the class's last."""
    lib = mirror_cuda.build.load()
    cap = mirror_cuda._cap(lib, card.index)
    n = 3 * cap * TILE_ROWS + 77
    planes, claims, nwords = _class(card, 5, 576, n, seed=7)
    assert mirror_cuda.verify_plan(n, cap, []) == cap
    assert _k4(planes, claims, 5, nwords) == 0
    bent = _copy(claims)
    rows = [t * TILE_ROWS + 5 for t in (0, cap, 2 * cap, 3 * cap)] + [n - 1]
    for i, row in enumerate(rows):
        bent[i % 8, row] ^= 1
    assert device_mirror.verify_planes_plain(planes, bent, 5, 576) == len(rows)
    assert _k4(planes, bent, 5, nwords) == len(rows)
