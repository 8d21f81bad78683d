"""Faults planted underneath the timed path, for the tests (on the CPU)
and for the controls (``python3 -m portbench.controls``, on the card).
The benchmark's own runs never plant one.

Each fault patches the program's kernel wrapper (on the card) and its
plain version (on the CPU) that the cell's entry reaches:

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

FAULTS = ("stale", "half", "altered", "cached")


def _hash_wrapper(orig, fault):
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


def _verify_wrapper(orig, fault):
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


def _admit_wrapper(orig):
    def wrapped(self, hashes, rows, lengths=None, exact=False):
        half = rows.shape[0] // 2 // 1024 * 1024
        return orig(self, hashes[:half], rows[:half],
                    lengths[:half] if lengths else None, exact)

    return wrapped


def _fetch_wrapper(orig):
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


def planted(fault: str, driver: str):
    """A context in which the timed path of the cells that ``driver``
    (a traffic's driver) runs carries ``fault``."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    from khipu_tpu_torch.ops import keccak_cuda, keccak_torch
    from khipu_tpu_torch.storage import device_mirror

    if driver == "hash_fixed":
        return _patched([
            (keccak_cuda, "absorb_fixed", _hash_wrapper(keccak_cuda.absorb_fixed, fault)),
            (keccak_torch, "absorb_fixed", _hash_wrapper(keccak_torch.absorb_fixed, fault)),
        ])
    if driver != "mirror_verify":
        raise ValueError(f"no faults for the driver {driver!r}")
    pairs = [(device_mirror, "verify_planes",
              _verify_wrapper(device_mirror.verify_planes, fault))]
    mirror, cls = device_mirror.DeviceNodeMirror, device_mirror._ClassMirror
    if fault == "half":
        pairs.append((mirror, "admit_packed", _admit_wrapper(mirror.admit_packed)))
    if fault == "altered":
        pairs.append((cls, "fetch_row", _fetch_wrapper(cls.fetch_row)))
    return _patched(pairs)


def cpu_launch_counters():
    """On the CPU the port runs the plain versions of K1f and K4, which
    launch nothing; this context counts each such call as the kernel's
    wrapper counts a launch on the card, so that the cells' launch
    checks can be exercised without a card."""
    from khipu_tpu_torch.ops import build, keccak_cuda, keccak_torch
    from khipu_tpu_torch.storage import device_mirror, mirror_cuda

    def counting(orig, wrapper, counter):
        def counted(data, *args, **kwargs):
            if not data.is_cuda:
                build.count_launch(wrapper.__name__, counter)
            return orig(data, *args, **kwargs)

        return counted

    return _patched([
        (keccak_torch, "absorb_fixed",
         counting(keccak_torch.absorb_fixed, keccak_cuda, "FIXED_LAUNCHES")),
        (device_mirror, "verify_planes",
         counting(device_mirror.verify_planes, mirror_cuda, "VERIFY_LAUNCHES")),
    ])
