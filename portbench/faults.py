"""Faults planted underneath the timed path, for the tests (on the CPU)
and for the controls (``python3 -m portbench.controls``, on the card).
The benchmark's own runs never plant one.

Each fault patches the program's kernel wrapper (on the card) and its
plain version (on the CPU) that the cell's entry reaches. Which
functions those are is the driver's to say (its ``fault_seams``); the
wrappers below are what a driver builds its seams from:

* ``stale``: the call returns the answer it gave before, unchanged;
* ``half``: half of the rows are left out (of each hash, of each
  verify, and of the mirror's admit);
* ``altered``: one answer is altered where it is produced (a digest, a
  verify's count, a row the mirror reads back);
* ``cached``: a call on an input seen before returns the answer it gave
  then, without running: every answer right, and no work done.

A cell on one card has no exchange between chips, so that fault does not
apply.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

from portbench import run

FAULTS = ("stale", "half", "altered", "cached")


def hash_wrapper(orig, fault):
    """A digest function ``orig(data, ...) -> u8[n, 32]`` with ``fault``."""
    state = {}

    def wrapped(data, *args, **kwargs):
        if fault == "stale" and "last" in state:
            return state["last"]
        if fault == "cached" and data.data_ptr() in state:
            return state[data.data_ptr()]
        if fault == "half":
            n = data.shape[0]
            out = orig(data[: n // 2].contiguous(), *args, **kwargs)
            full = out.new_zeros((n, out.shape[1]))
            full[: n // 2] = out
            return full
        out = orig(data, *args, **kwargs)
        if fault == "altered":
            out[0, 0] ^= 1
        state["last"] = state[data.data_ptr()] = out
        return out

    return wrapped


def verify_wrapper(orig, fault):
    """A verify ``orig(planes, claimed, nblocks, exact_len) -> count``
    with ``fault``."""
    state = {}

    def wrapped(planes, claimed, nblocks, exact_len):
        if fault == "stale" and "last" in state:
            return state["last"]
        if fault == "cached" and planes.data_ptr() in state:
            return state[planes.data_ptr()]
        if fault == "half":
            n = planes.shape[1]
            return orig(planes[:, : n // 2], claimed[:, : n // 2], nblocks,
                        exact_len)
        count = orig(planes, claimed, nblocks, exact_len)
        if fault == "altered":
            count += 1
        state["last"] = state[planes.data_ptr()] = count
        return count

    return wrapped


def admit_wrapper(orig):
    """An ``admit_packed`` method that admits half of the rows (whole
    tiles of 1,024)."""
    def wrapped(self, hashes, rows, lengths=None, exact=False):
        half = rows.shape[0] // 2 // 1024 * 1024
        return orig(self, hashes[:half], rows[:half],
                    lengths[:half] if lengths else None, exact)

    return wrapped


def fetch_wrapper(orig):
    """A ``fetch_row`` method whose first row read back has one bit
    altered."""
    state = {"done": False}

    def wrapped(self, key):
        row = orig(self, key)
        if row and not state["done"]:
            state["done"] = True
            row = bytes([row[0] ^ 1]) + row[1:]
        return row

    return wrapped


@contextlib.contextmanager
def _patched(pairs):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    try:
        for mod, name, new in pairs:
            setattr(mod, name, new)
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def _declared(driver: str, bench_dir: Path, signature: str):
    """The function that the driver's module declares by ``signature``."""
    name = signature.split("(")[0]
    fn = getattr(run.load_driver(bench_dir, driver), name, None)
    if fn is None:
        raise ValueError(f"the driver {driver!r} declares no {name}: its module "
                         f"has to define {signature}")
    return fn


def planted(fault: str, driver: str, bench_dir: Path = run.BENCH_DIR):
    """A context in which the timed path of the cells that ``driver``
    (a traffic's driver, found under ``bench_dir``) runs carries
    ``fault``: the driver's ``fault_seams(fault)`` patched in."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    seams = _declared(driver, bench_dir, "fault_seams(fault) -> "
                      "[(owner, attribute, replacement), ...]")(fault)
    if not seams:
        raise ValueError(f"the driver {driver!r} plants no seam for {fault!r}")
    return _patched(seams)


def _counting(orig, wrapper, counter: str):
    """``orig`` (a plain version, first argument a tensor) counting each
    call on the CPU as ``wrapper``'s launch counter ``counter`` counts a
    launch on the card."""
    from khipu_tpu_torch.ops import build

    def counted(data, *args, **kwargs):
        if not data.is_cuda:
            build.count_launch(wrapper.__name__, counter)
        return orig(data, *args, **kwargs)

    return counted


def cpu_launch_counters(driver: str, bench_dir: Path = run.BENCH_DIR):
    """On the CPU the port runs the plain versions of its kernels, which
    launch nothing; this context counts each call of the plain versions
    that ``driver`` declares (its ``cpu_launch_seams()``) as the kernel's
    wrapper counts a launch on the card, so that the cells' launch
    checks can be exercised without a card."""
    seams = _declared(driver, bench_dir, "cpu_launch_seams() -> "
                      "[(owner, attribute, wrapper module, counter), ...]")()
    return _patched([(owner, name, _counting(getattr(owner, name), wrapper, counter))
                     for owner, name, wrapper, counter in seams])
