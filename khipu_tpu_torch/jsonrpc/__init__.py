"""JSON-RPC API (khipu-eth/.../jsonrpc/ role): the port's copy of
``khipu_tpu.jsonrpc``."""

from khipu_tpu_torch.jsonrpc.eth_service import EthService
from khipu_tpu_torch.jsonrpc.personal_service import PersonalService
from khipu_tpu_torch.jsonrpc.server import JsonRpcServer

__all__ = ["EthService", "JsonRpcServer", "PersonalService"]
