"""Each driver declares its own fault seams and launch seams; the faults
patch what the driver declares, and refuse a driver that declares none."""

import pytest

from portbench import faults, run


def _expected(driver, fault):
    from khipu_tpu_torch.ops import keccak_cuda, keccak_torch
    from khipu_tpu_torch.storage import device_mirror

    if driver == "hash_fixed":
        return [(keccak_cuda, "absorb_fixed"), (keccak_torch, "absorb_fixed")]
    seams = [(device_mirror, "verify_planes")]
    if fault == "half":
        seams.append((device_mirror.DeviceNodeMirror, "admit_packed"))
    if fault == "altered":
        seams.append((device_mirror._ClassMirror, "fetch_row"))
    return seams


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("driver", ["hash_fixed", "mirror_verify"])
def test_fault_seams_are_the_drivers(driver, fault):
    seams = run.load_driver(run.BENCH_DIR, driver).fault_seams(fault)
    assert [(owner, name) for owner, name, _ in seams] == _expected(driver, fault)
    assert all(callable(new) for _, _, new in seams)
    originals = [getattr(owner, name) for owner, name in _expected(driver, fault)]
    with faults.planted(fault, driver):
        assert all(getattr(owner, name) is not old for (owner, name), old
                   in zip(_expected(driver, fault), originals))
    assert [getattr(owner, name) for owner, name in _expected(driver, fault)] == originals


@pytest.mark.parametrize("driver, counter", [("hash_fixed", "FIXED_LAUNCHES"),
                                             ("mirror_verify", "VERIFY_LAUNCHES")])
def test_cpu_launch_seams_are_the_drivers(driver, counter):
    from khipu_tpu_torch.ops import keccak_cuda, keccak_torch
    from khipu_tpu_torch.storage import device_mirror, mirror_cuda

    want = {"hash_fixed": (keccak_torch, "absorb_fixed", keccak_cuda),
            "mirror_verify": (device_mirror, "verify_planes", mirror_cuda)}[driver]
    assert run.load_driver(run.BENCH_DIR, driver).cpu_launch_seams() == [(*want, counter)]


NO_SEAMS = '''
class Driver:
    in_flight = 1
'''


def test_a_driver_without_seams_is_refused(tmp_path):
    (tmp_path / "drivers").mkdir()
    (tmp_path / "drivers" / "no_seams.py").write_text(NO_SEAMS)
    with pytest.raises(ValueError, match="fault_seams"):
        faults.planted("stale", "no_seams", tmp_path)
    with pytest.raises(ValueError, match="cpu_launch_seams"):
        faults.cpu_launch_counters("no_seams", tmp_path)
    (tmp_path / "drivers" / "no_seams.py").write_text(
        NO_SEAMS + "\n\ndef fault_seams(fault):\n    return []\n")
    with pytest.raises(ValueError, match="no seam"):
        faults.planted("stale", "no_seams", tmp_path)
