"""A replay that returned is durable on every persistent engine.

A child process replays the 8-block transfer chain of
``test_torch_reorg.py`` into ``Storages(engine, dir)`` (per block, and
windowed at 3 and 4 blocks) and ends in ``os._exit`` the moment
``replay()`` returns: no ``stop``, no flush, no interpreter teardown,
so whatever a store still held in a user-space buffer is gone. A second,
fresh process reopens the directory: best is 8, block 8's hash-to-number
record is there, the commit journal has nothing pending, recovery finds
nothing to do, and every header's state root and every block's receipts
equal an uninterrupted in-memory run.

The ``native`` engine keeps each topic's newest appends in a stdio
buffer; ``Storages.flush_writes`` hands them to the OS before a window's
commit mark and after every block. ``sqlite`` and ``kesque`` write
through on every put.
"""

import multiprocessing
import os

import pytest

from khipu_tpu_torch.sync.journal import recover
from tests.test_torch_reorg import _reorg_namespace, build

ENGINES = ["native", "sqlite", "kesque"]
# what a child keeps alive until its ``os._exit``: a store that went out
# of scope would close (and flush) before the death
_KEEP = []
WINDOWS = [1, 3, 4]
N_BLOCKS = 8
# children fork from a single-threaded server that has this module
# imported, not from the test process and its threads
_CTX = multiprocessing.get_context("forkserver")
_CTX.set_forkserver_preload([__name__])


def _child(conn, fn_name, args):
    try:
        out = ("ok", globals()[fn_name](*args))
    except BaseException as e:  # noqa: BLE001 report, never unwind
        out = ("err", repr(e))
    conn.send(out)
    os._exit(0)


def _in_child(fn, *args, timeout=60.0):
    """Run ``fn(*args)`` in a child process; return its result. The child
    ends in ``os._exit`` right after ``fn`` returns. Bounded: a child
    that has not answered at ``timeout`` is killed and the test fails."""
    recv, send = _CTX.Pipe(duplex=False)
    proc = _CTX.Process(target=_child, args=(send, fn.__name__, args))
    proc.start()
    send.close()
    try:
        if not recv.poll(timeout):
            proc.kill()
            pytest.fail(f"child still running after {timeout} s")
        status, value = recv.recv()
    finally:
        recv.close()
        proc.join(timeout)
    assert status == "ok", value
    return value


def _cfg(ns, window):
    import dataclasses

    return dataclasses.replace(ns.RCFG, sync=ns.SyncConfig(
        commit_window_blocks=window, parallel_tx=False))


def _replay_then_die(engine, data_dir, window, blocks):
    ns = _reorg_namespace("port")
    cfg = _cfg(ns, window)
    bc = ns.Blockchain(ns.Storages(engine, data_dir), cfg)
    bc.load_genesis(ns.GenesisSpec(alloc=ns.ALLOC))
    ns.new_driver(bc, cfg).replay(blocks)
    _KEEP.append(bc)  # alive, unflushed, at the os._exit
    return bc.best_block_number


def _reopen(engine, data_dir, window, tip_hash):
    ns = _reorg_namespace("port")
    cfg = _cfg(ns, window)
    storages = ns.Storages(engine, data_dir)
    bc = ns.Blockchain(storages, cfg)
    out = {
        "best": bc.best_block_number,
        "number_of_tip": storages.block_numbers.number_of(tip_hash),
        "pending": len(storages.window_journal.pending()),
        "roots": [getattr(bc.get_header_by_number(n), "state_root", None)
                  for n in range(N_BLOCKS + 1)],
        "receipts": [storages.receipts_storage.get(n)
                     for n in range(1, N_BLOCKS + 1)],
    }
    report = recover(bc, config=cfg, device="cpu")
    out["scanned"] = report.scanned
    out["best_after"] = bc.best_block_number
    storages.stop()
    return out


@pytest.fixture(scope="module")
def chain():
    ns = _reorg_namespace("port")
    bc, blocks = build(ns, N_BLOCKS)
    ref = {
        "roots": [bc.get_header_by_number(n).state_root
                  for n in range(N_BLOCKS + 1)],
        "receipts": [bc.storages.receipts_storage.get(n)
                     for n in range(1, N_BLOCKS + 1)],
    }
    return blocks, ref


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("engine", ENGINES)
def test_replay_survives_process_death(chain, engine, window, tmp_path):
    blocks, ref = chain
    data_dir = str(tmp_path / engine)
    assert _in_child(_replay_then_die, engine, data_dir, window,
                     blocks) == N_BLOCKS
    got = _in_child(_reopen, engine, data_dir, window, blocks[-1].hash)
    assert got["best"] == N_BLOCKS
    assert got["number_of_tip"] == N_BLOCKS
    assert got["pending"] == 0
    assert got["scanned"] == 0 and got["best_after"] == N_BLOCKS
    assert got["roots"] == ref["roots"]
    assert got["receipts"] == ref["receipts"]
