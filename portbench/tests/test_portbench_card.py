"""On the card (``python3 -m pytest portbench/tests -m card``): every
cell at a small size comes out correct through the kernels, and the
control and each fault come out not correct. Skips without a card."""

import time

import pytest

from portbench import faults, run

MANIFEST = run.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SMALL = {"rows": 64 * 1024}


def _run(workload, device, **kw):
    return run.run_cell(workload, 2**31 + 99, 0.5, False, device,
                        manifest=MANIFEST, sizes=SMALL, t0=time.perf_counter(),
                        **kw)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, card):
    result, _ = _run(workload, card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    traced, _ = run.run_cell(workload, 5, 0.5, True, card, manifest=MANIFEST,
                             sizes=SMALL, t0=time.perf_counter())
    assert traced["correct"] and traced["device"]["busy_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_on_the_card(workload, card):
    result, _ = _run(workload, card, control_rounds=12)
    assert not result["correct"]
    for fault in faults.FAULTS:
        with faults.planted(fault, run.Cell(MANIFEST, workload).traffic["driver"]):
            result, _ = _run(workload, card)
        assert not result["correct"], (fault, result["checks"])
