"""Device selection shared by every entry point of the port.

``device=None`` means the card. A caller that wants the plain PyTorch
versions on the CPU says so with ``device="cpu"``; asking for the card
where there is none raises instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on, with a CUDA device's index made
    explicit (``cuda`` -> ``cuda:<current>``) so tensors compare equal."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "khipu_tpu_torch: the card was asked for (device=None means "
                "'cuda') but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
