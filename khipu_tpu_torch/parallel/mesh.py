"""The device mesh of the node-sharding axis, over ``torch.distributed``.

The counterpart of ``khipu_tpu/parallel/mesh.py``. One 1-D axis
("nodes") carries all data parallelism: trie nodes are content-addressed
and independent under hashing, so a node batch splits evenly across
ranks, as Akka Cluster Sharding of NodeEntity splits it across hosts in
the reference client (entity/NodeEntity.scala:28).

The JAX package drives every chip from one controller process. The
port runs one process per rank (torch SPMD, started by ``torchrun``):
every rank calls the same function on the same whole batch, works on its
own contiguous share on its own device, and the collectives (NCCL on
the cards, gloo on the CPU) stitch the shares together.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from khipu_tpu_torch.device import resolve_device

AXIS = "nodes"


@dataclass
class Mesh:
    """One rank's view of the mesh: the process group (None for the
    default group), this rank, the world size, the rank's device and the
    group's backend. ``collectives`` counts the collectives this rank
    issued, by name; ``owns_group`` says that ``device_mesh`` started the
    default group, which ``close`` then ends."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool = False
    collectives: Dict[str, int] = field(default_factory=dict)

    def share(self, n: int) -> tuple:
        """This rank's contiguous share ``[lo, hi)`` of ``n`` rows: shares
        of ``ceil(n / size)`` rows, the last ones shorter or empty, so
        rank r's rows start at ``r * ceil(n / size)`` and an all_gather of
        equal-sized (padded) shares lays every row at its own index."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)

    def all_gather_rows(self, local: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One all_gather of each rank's contiguous ``local`` (the same
        shape on every rank) into ``out``, ``[size * rows, ...]`` on this
        rank's device (allocated when not given). Blocking: it orders
        after the kernels enqueued on the current stream, and its result
        is ready for the kernels after it. Gloo takes it on CUDA tensors
        too (two ranks sharing one card)."""
        if out is None:
            out = torch.empty((self.size * local.shape[0],)
                              + tuple(local.shape[1:]),
                              dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(out, local, group=self.group)
        self._count("all_gather")
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """One blocking all_reduce (SUM) of ``t`` across the mesh, in
        place; returns ``t``."""
        dist.all_reduce(t, group=self.group)
        self._count("all_reduce")
        return t

    def _count(self, op: str) -> None:
        self.collectives[op] = self.collectives.get(op, 0) + 1

    def close(self) -> None:
        """End the default group if ``device_mesh`` started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def device_mesh(n_devices: Optional[int] = None, device=None,
                backend: Optional[str] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """This rank's mesh over the world of the default process group.

    ``device=None`` means the cards: rank r on ``cuda:LOCAL_RANK`` over
    NCCL; a world larger than the cards raises ValueError, as the JAX
    package's ``device_mesh`` does when more devices are asked for than
    exist, unless ``devices`` names each rank's device (two ranks on one
    card then need ``backend="gloo"``: NCCL refuses a card twice). No
    card raises RuntimeError; it never picks gloo on the CPU instead.
    ``device="cpu"`` means gloo on the CPU.

    Without a default group, one is started from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or as a
    world of one over a free localhost port when that is absent; such a
    mesh's ``close`` ends it. ``n_devices``, when given, must equal the
    world size."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        kinds = {d.type for d in devices}
        if len(kinds) != 1:
            raise ValueError("devices must all be cards or all the CPU")
        dev_type = kinds.pop()
    else:
        dev_type = "cpu" if device is not None and \
            torch.device(device).type == "cpu" else "cuda"
    if dev_type == "cuda":
        resolve_device(None)  # raises without a card
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU; the CPU mesh is gloo")

    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the default group is {dist.get_backend()}, "
                             f"not {backend}")
        rank, world, init = dist.get_rank(), dist.get_world_size(), None
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        rank, world, init = 0, 1, f"tcp://127.0.0.1:{_free_port()}"
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the world has "
                         f"{world} ranks")
    local = _rank_device(rank, world, dev_type, devices)
    if local.type == "cuda":
        torch.cuda.set_device(local)
    if init is not None:
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
    return Mesh(None, rank, world, local, backend, init is not None)


def _rank_device(rank: int, world: int, dev_type: str,
                 devices: Optional[Sequence[torch.device]]) -> torch.device:
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices named for {world} ranks")
        return devices[rank]
    if dev_type == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(f"requested {world} devices, only {cards} available")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local)


def pad_to_shards(n: int, n_shards: int, floor: int = 1) -> int:
    """Smallest count >= max(n, floor) divisible by ``n_shards``."""
    n = max(n, floor)
    return ((n + n_shards - 1) // n_shards) * n_shards
