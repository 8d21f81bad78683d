"""VM backend dispatch.

The ledger calls `run_message_call` / `run_create` instead of binding
directly to evm.vm. The port has the Python interpreter only: the JAX
package's native C++ core (``native/csrc/evm.cc``) is not ported yet
(ROADMAP), so forcing it with ``set_backend("native")`` or
``KHIPU_VM_BACKEND=native`` raises instead of running Python quietly.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from khipu_tpu_torch.evm import vm as pyvm
from khipu_tpu_torch.evm.config import EvmConfig
from khipu_tpu_torch.evm.vm import MessageEnv, ProgramResult

_FORCED: Optional[str] = None  # None=auto | "python" | "native"


def set_backend(name: Optional[str]) -> None:
    """Force a backend ("python" / "native") or None for auto."""
    global _FORCED
    _FORCED = name


def _check_backend() -> None:
    if (_FORCED or os.environ.get("KHIPU_VM_BACKEND")) == "native":
        raise NotImplementedError(
            "the native VM backend (native/csrc/evm.cc) is not ported to "
            "khipu_tpu_torch yet (ROADMAP); only the Python VM runs"
        )


def run_message_call(
    config: EvmConfig,
    world,
    block,
    env: MessageEnv,
    code: bytes,
    gas: int,
    code_address: bytes,
    pre_transfer: bool = False,
) -> ProgramResult:
    """Top-level message call (execute_transaction's CALL path).

    ``pre_transfer``: apply the tx-level value transfer + target touch
    inside the frame (so it rolls back with the frame), on a world copy.
    """
    _check_backend()
    target = world
    if pre_transfer:
        target = world.copy()
        target.transfer(env.caller, env.owner, env.value)
        target.touch(env.owner)
    return pyvm._execute_message(
        config, target, block, env, code, gas, code_address
    )


def run_create(
    config: EvmConfig,
    world,
    block,
    caller: bytes,
    origin: bytes,
    new_addr: bytes,
    gas: int,
    gas_price: int,
    value: int,
    init_code: bytes,
    depth: int,
) -> Tuple[ProgramResult, bytes]:
    """Top-level contract creation (execute_transaction's CREATE path)."""
    _check_backend()
    return pyvm.create_contract(
        config, world, block, caller, origin, new_addr, gas, gas_price,
        value, init_code, depth,
    )
