"""The roofline counts and the readers that divide by them."""

import pytest

from portbench import roofline, run
from portbench.common import Reading
from portbench.devtrace import DeviceTrace, Event

MANIFEST = run.load_manifest()


def test_counts():
    assert roofline.SPONGE_OPS_PER_BLOCK == 4354
    assert roofline.H100_INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert roofline.rate_blocks(576) == 5
    assert roofline.rate_blocks(135) == 1 and roofline.rate_blocks(136) == 2


def test_k1f_bound_at_a_batch():
    s, by = roofline.hash_bound_s(1 << 20, 576)
    assert by == "operations"
    assert s * 1e3 == pytest.approx(1.3648, abs=1e-4)
    assert (1 << 20) * 608 / 3.35e12 < s


def test_k4_bound_at_ten_million_rows():
    s, by = roofline.verify_bound_s(10 * (1 << 20), 576)
    assert by == "operations"
    assert s * 1e3 == pytest.approx(13.648, abs=1e-3)


@pytest.mark.parametrize("bound, rows, ms", [
    (roofline.hash_bound_s, 1 << 20, 1.3648),
    (roofline.verify_bound_s, 10 * (1 << 20), 13.648),
])
def test_bound_from_counted_work(bound, rows, ms):
    """``bound_s`` over the counted work equals the equal-length bound at
    both cells' sizes, to the last digit."""
    blocks = rows * roofline.rate_blocks(576)
    moved = rows * (576 + roofline.DIGEST) + (4 if bound is roofline.verify_bound_s else 0)
    assert roofline.bound_s(blocks, moved) == bound(rows, 576)
    assert roofline.bound_s(blocks, moved)[0] * 1e3 == pytest.approx(ms, abs=1e-3)


def test_bound_of_a_mix_is_the_sum_of_its_parts():
    # 1-block leaves and 4-block branches, each bounded by its operations
    parts = [(1 << 20, 100), (1 << 16, 532)]
    each = [roofline.verify_bound_s(n, length) for n, length in parts]
    assert all(by == "operations" for _, by in each)
    blocks = sum(n * roofline.rate_blocks(length) for n, length in parts)
    moved = sum(n * (length + roofline.DIGEST) for n, length in parts) + 4
    s, by = roofline.bound_s(blocks, moved)
    assert by == "operations"
    assert s == pytest.approx(sum(t for t, _ in each), rel=1e-12)
    # bytes bound a mix only where they outweigh the operations
    assert roofline.bound_s(1, 10**9)[1] == "bytes"


def _reading(config, kernels, copies=(), window_s=1.0, calls=1):
    return Reading(config=config, traffic={}, setup_s=1.0, calls=calls,
                   window_s=window_s, nodes_per_call=config["rows"],
                   trace=DeviceTrace(window_s=window_s, kernels=list(kernels),
                                     copies=list(copies)))


@pytest.mark.parametrize("metric, kernel, bound", [
    ("k1f_roofline", "void keccak256_fixed_kernel<true>(...)", roofline.hash_bound_s),
    ("k4_roofline", "mirror_verify_kernel(...)", roofline.verify_bound_s),
])
def test_roofline_readers(metric, kernel, bound):
    cell = run.Cell(MANIFEST, MANIFEST["workloads"][0]["name"])
    reader = cell.reader({"name": metric})
    config = {"rows": 1 << 20, "row_bytes": 576}
    bound_us = bound(1 << 20, 576)[0] * 1e6
    at_bound = [Event(kernel, 0.0, bound_us), Event(kernel, 10 * bound_us, bound_us)]
    assert reader.read(_reading(config, at_bound)) == pytest.approx(100.0)
    twice = [Event(kernel, 0.0, 2 * bound_us)]
    assert reader.read(_reading(config, twice)) == pytest.approx(50.0)
    assert reader.read(_reading(config, [Event("other", 0.0, 5.0)])) is None


def test_trace_readers():
    cell = run.Cell(MANIFEST, MANIFEST["workloads"][0]["name"])
    config = {"rows": 1 << 20, "row_bytes": 576}
    copies = [Event("Memcpy HtoD (Pinned -> Device)", 0.0, 1000.0)]
    kernels = [Event("mirror_verify_kernel", 1000.0, 2000.0)]
    r = _reading(config, kernels, copies, window_s=0.004, calls=2)
    assert cell.reader({"name": "device_idle_share"}).read(r) == pytest.approx(25.0)
    # 2 ms a call of host wall, 2 ms of K4 in it
    assert cell.reader({"name": "verify_host_ms"}).read(r) == pytest.approx(0.0)
    r.trace.copies.append(Event("Memcpy HtoD (Pinned -> Device)", 500.0, 1000.0))
    assert r.trace.busy_s() == pytest.approx(0.003)
    assert r.trace.idle_gaps() == []
    empty = _reading(config, [])
    for name in ("device_idle_share", "verify_host_ms",
                 "k1f_roofline", "k4_roofline", "admit_us_per_row"):
        assert cell.reader({"name": name}).read(empty) is None
