"""The plain reference against published Keccak-256 vectors, against
Python's SHA3-256 (the same permutation under the FIPS 202 pad), and
its two forms against each other."""

import ast
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference

VECTORS = {
    b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
    b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
    b"The quick brown fox jumps over the lazy dog":
        "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15",
}
LENGTHS = (0, 1, 31, 32, 135, 136, 137, 271, 272, 543, 544, 576, 1000)


@pytest.mark.parametrize("message", list(VECTORS))
def test_published_vectors(message):
    assert reference.keccak256_np(message).tobytes().hex() == VECTORS[message]
    rows = torch.from_numpy(np.frombuffer(message, np.uint8).copy())[None, :]
    assert reference.keccak256_rows(rows).numpy().tobytes().hex() == VECTORS[message]


@pytest.mark.parametrize("length", LENGTHS)
def test_sha3_pad_matches_hashlib(length):
    rows = np.random.default_rng(length).integers(0, 256, (3, length), dtype=np.uint8)
    want = np.stack([np.frombuffer(hashlib.sha3_256(r.tobytes()).digest(), np.uint8)
                     for r in rows])
    assert (reference.keccak256_np(rows, delim=0x06) == want).all()
    got = reference.keccak256_rows(torch.from_numpy(rows), delim=0x06).numpy()
    assert (got == want).all()


def test_forms_agree_in_blocks_of_rows():
    rows = np.random.default_rng(7).integers(0, 256, (10, 576), dtype=np.uint8)
    want = reference.keccak256_np(rows)
    got = reference.keccak256_rows(torch.from_numpy(rows), block_rows=3).numpy()
    assert (got == want).all()


def test_fewer_rounds_differ_everywhere():
    rows = torch.randint(0, 256, (64, 576), dtype=torch.uint8)
    full = reference.keccak256_rows(rows)
    weak = reference.keccak256_rows(rows, rounds=12)
    assert bool((full != weak).any(dim=1).all())
    assert reference.mismatches(rows, full) == 0
    assert reference.mismatches(rows, full, rounds=12) == 64


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse(Path(reference.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "numpy", "torch"}, names
