"""``python -m khipu_tpu_torch`` — node entry point (Khipu.scala:45 role).

The port's copy of ``python -m khipu_tpu``, with one more flag:
``--device`` names where the node commits (``cuda`` by default, the
card; ``cpu`` asks for the plain versions). The node commits
``COMMIT_WINDOW_BLOCKS`` blocks at a time. The bridge (bridge.py)
starts by default on ``--bridge-port``, speaks HTTP, not gRPC, and its
``ExecuteBlocks`` always commits on ``--device`` through the windowed
device commit: the reference's ``--device-commit`` has no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import threading

# blocks a trie commit takes: the windowed device commit, one K5 launch
# a window (the window chip_smoke's replays and bridge phase run)
COMMIT_WINDOW_BLOCKS = 8


def parse_args(argv=None) -> argparse.Namespace:
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
    parser.add_argument("--device", default=None,
                        help="where the node commits: the card (default) "
                        "or cpu")
    return parser.parse_args(argv)


def start_node(args: argparse.Namespace):
    """Build the board and start the services ``args`` ask for; returns
    the started board (shut down here if a start fails)."""
    from khipu_tpu_torch.config import DbConfig, fixture_config
    from khipu_tpu_torch.service_board import ServiceBoard

    config = fixture_config(chain_id=args.chain_id)
    config = dataclasses.replace(
        config,
        db=DbConfig(engine=args.engine, data_dir=args.data_dir),
        sync=dataclasses.replace(
            config.sync, commit_window_blocks=COMMIT_WINDOW_BLOCKS
        ),
    )
    board = ServiceBoard(config, device=args.device)
    try:
        print(f"chain head: #{board.blockchain.best_block_number}",
              flush=True)
        if not args.no_rpc:
            port = board.start_rpc(port=args.rpc_port)
            print(f"JSON-RPC on http://127.0.0.1:{port}", flush=True)
        if not args.no_bridge:
            port = board.start_bridge(port=args.bridge_port)
            print(f"bridge on 127.0.0.1:{port}", flush=True)
        if not args.no_network:
            port = board.start_network(port=args.p2p_port)
            print(f"RLPx listening on {port}", flush=True)
            dport = board.start_discovery(port=0)
            print(f"discovery (UDP) on {dport}", flush=True)
    except BaseException:
        board.shutdown()
        raise
    return board


def main(argv=None) -> int:
    args = parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    board = start_node(args)
    try:
        stop.wait()
    finally:
        board.shutdown()
        print("shut down cleanly", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
