"""``python -m khipu_tpu_torch`` — node entry point (Khipu.scala:45 role).

The port's copy of ``python -m khipu_tpu``, with its flags and one more:
``--device`` names where the node commits (``cuda`` by default, the
card; ``cpu`` asks for the plain versions). The gRPC bridge is not
ported (ROADMAP A11): the default bridge start raises
``NotImplementedError`` through ``ServiceBoard.start_bridge``, so pass
``--no-bridge`` until then.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="khipu_tpu_torch", description="khipu-tpu node on PyTorch"
    )
    parser.add_argument("--engine", default="memory",
                        choices=["memory", "native", "sqlite"])
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--chain-id", type=int, default=1)
    parser.add_argument("--rpc-port", type=int, default=8546)
    parser.add_argument("--bridge-port", type=int, default=50051)
    parser.add_argument("--p2p-port", type=int, default=30303)
    parser.add_argument("--no-rpc", action="store_true")
    parser.add_argument("--no-bridge", action="store_true")
    parser.add_argument("--no-network", action="store_true")
    parser.add_argument("--device-commit", action="store_true",
                        help="route the bridge's trie commits through "
                        "the device (the bridge is not ported yet)")
    parser.add_argument("--device", default=None,
                        help="where the node commits: the card (default) "
                        "or cpu")
    args = parser.parse_args(argv)

    from khipu_tpu_torch.config import DbConfig, fixture_config
    from khipu_tpu_torch.service_board import ServiceBoard

    config = dataclasses.replace(
        fixture_config(chain_id=args.chain_id),
        db=DbConfig(engine=args.engine, data_dir=args.data_dir),
    )
    board = ServiceBoard(config, device=args.device)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        print(f"chain head: #{board.blockchain.best_block_number}",
              flush=True)
        if not args.no_rpc:
            port = board.start_rpc(port=args.rpc_port)
            print(f"JSON-RPC on http://127.0.0.1:{port}", flush=True)
        if not args.no_bridge:
            port = board.start_bridge(
                port=args.bridge_port, device_commit=args.device_commit
            )
            print(f"gRPC bridge on 127.0.0.1:{port}", flush=True)
        if not args.no_network:
            port = board.start_network(port=args.p2p_port)
            print(f"RLPx listening on {port}", flush=True)
            dport = board.start_discovery(port=0)
            print(f"discovery (UDP) on {dport}", flush=True)
        stop.wait()
    finally:
        board.shutdown()
        print("shut down cleanly", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
