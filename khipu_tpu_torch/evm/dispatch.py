"""VM backend dispatch: the native C++ core unless a rule routes to Python.

The ledger calls `run_message_call` / `run_create` instead of binding
directly to evm.vm; each call picks the backend. A frame runs on the
native core (``native/csrc/evm.cc`` through ``evm/native_vm.py``) unless

  * the backend is forced to Python, by ``set_backend("python")`` or
    ``KHIPU_VM_BACKEND=python``;
  * an opcode trace is active (debug tracing hooks the Python loop);
  * the frame's gas is at least the native core's int64 budget (never on
    real chains).

These are routing rules, not fallbacks: a failed build of the host
library or a failed native call raises, and nothing then runs the
Python VM in its place. Both backends produce identical ProgramResults
and identical world write-log / read-set effects
(tests/test_torch_native_evm.py). ``VM_GAUGES`` counts the top-level
frames each backend ran.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

from khipu_tpu_torch.evm import native_vm
from khipu_tpu_torch.evm import vm as pyvm
from khipu_tpu_torch.evm.config import EvmConfig
from khipu_tpu_torch.evm.vm import MessageEnv, ProgramResult
from khipu_tpu_torch.observability.registry import REGISTRY

VM_GAUGES = REGISTRY.gauge_group("khipu_vm", {
    "native_frames": 0, "python_frames": 0})
# the exec pool's threads run frames at once; a gauge's += is a read
# and a write
_VM_GAUGES_LOCK = threading.Lock()

_FORCED: Optional[str] = None  # None=auto | "python" | "native"


def set_backend(name: Optional[str]) -> None:
    """Force a backend ("python" / "native") or None for auto."""
    global _FORCED
    _FORCED = name


def use_native(gas: int) -> bool:
    forced = _FORCED or os.environ.get("KHIPU_VM_BACKEND")
    if forced == "python":
        return False
    if pyvm._TRACE is not None:  # opcode tracing hooks the Python loop
        return False
    ok = gas < native_vm.MAX_NATIVE_GAS
    if forced == "native" and not ok:
        raise RuntimeError(f"native VM backend forced for {gas} gas, over "
                           "the native core's budget")
    return ok


def _count(native: bool) -> None:
    key = "native_frames" if native else "python_frames"
    with _VM_GAUGES_LOCK:
        VM_GAUGES[key] += 1


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
    inside the frame (so it rolls back with the frame). The Python path
    applies it to a world copy; the native path emits it into the
    frame's op log.
    """
    native = use_native(gas)
    _count(native)
    if native:
        return native_vm.native_execute_message(
            config, world, block, env, code, gas, code_address,
            pre_transfer=pre_transfer,
        )
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
    native = use_native(gas)
    _count(native)
    if native:
        return native_vm.native_create_contract(
            config, world, block, caller, origin, new_addr, gas,
            gas_price, value, init_code, depth,
        )
    return pyvm.create_contract(
        config, world, block, caller, origin, new_addr, gas, gas_price,
        value, init_code, depth,
    )
