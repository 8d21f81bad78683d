"""Wrapper of kernel K6 (``csrc/exec_validate.cu``): the execute stage's
row validation, one thread a row.

``validate_rows`` takes the packed rows on the card (int32[n, 20], the
u32 words of ``fused.pack_exec_rows``) and returns the u8[n] mask.
``LAUNCHES`` counts the kernel's launches; it is raised only where the
kernel is launched. The library is built at first use
(``ops/build.py``).
"""

from __future__ import annotations

import torch

from khipu_tpu_torch.ops import build

ROW_WORDS = 20  # tx nonce 2, account nonce 2, balance 8, upfront 8
LAUNCHES = 0


def validate_rows(rows: torch.Tensor) -> torch.Tensor:
    """K6: u8[n] mask, 1 where row ``r`` of ``rows`` (int32[n, 20] on
    the card, contiguous, 16-byte aligned) has the transaction's nonce
    equal to the account's and a balance covering the upfront cost."""
    if not rows.is_cuda:
        raise ValueError("K6 takes CUDA tensors only")
    if rows.dtype != torch.int32 or rows.dim() != 2 or (
        rows.shape[1] != ROW_WORDS
    ):
        raise ValueError(f"rows must be int32[n, {ROW_WORDS}]")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")
    n = rows.shape[0]
    ok = torch.empty(n, dtype=torch.uint8, device=rows.device)
    if n == 0:
        return ok
    lib = build.load()
    dev, stream = build.launch_args(rows)
    rc = lib.khipu_exec_validate(rows.data_ptr(), n, ok.data_ptr(), dev,
                                 stream)
    if rc:
        raise RuntimeError(f"K6 exec-validate kernel launch failed: cudaError {rc}")
    build.count_launch(__name__, "LAUNCHES")
    return ok
