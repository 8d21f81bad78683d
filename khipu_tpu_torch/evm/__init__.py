"""EVM: fork-gated interpreter, gas schedules, precompiles; the native
C++ core's adapter (``native_vm``) and the per-frame backend dispatch.

Parity: khipu-eth/src/main/scala/khipu/vm/ (VM.scala, OpCode.scala,
EvmConfig.scala, Stack/Memory/Program, PrecompiledContracts.scala) and
crypto/zksnark (bn128.py).

Submodule attributes resolve lazily: domain types import
``evm.dataword`` while ``evm.vm`` imports domain types, so an eager
re-export here would be a cycle.
"""

_LAZY = {
    "EvmConfig": ("khipu_tpu_torch.evm.config", "EvmConfig"),
    "FeeSchedule": ("khipu_tpu_torch.evm.config", "FeeSchedule"),
    "for_block": ("khipu_tpu_torch.evm.config", "for_block"),
    "Program": ("khipu_tpu_torch.evm.program", "Program"),
    "BlockEnv": ("khipu_tpu_torch.evm.vm", "BlockEnv"),
    "MessageEnv": ("khipu_tpu_torch.evm.vm", "MessageEnv"),
    "ProgramResult": ("khipu_tpu_torch.evm.vm", "ProgramResult"),
    "create_contract": ("khipu_tpu_torch.evm.vm", "create_contract"),
    "run": ("khipu_tpu_torch.evm.vm", "run"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
