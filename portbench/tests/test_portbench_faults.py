"""The check catches what a broken program would deliver: each fault below
is planted under the timed path of a CPU rehearsal, and ``correct`` comes
out false; so does the TF32 control. The program's own control (its TF32
path in cuBLAS and cuDNN) exists only on the card."""

import pytest
import torch

from conftest import SMALL, small_cell
from faults import FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch, cpu_port):
    from portbench import harness

    FAULTS[fault](monkeypatch.setattr)
    rc, line, _ = harness.run_cell(name, 7_000_000_001, 0.5, False, cpu=True,
                                   cell=small_cell(name))
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["err"]["value"] > line["checks"]["err"]["limit"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_tf32_reference_control_is_not_correct(name, cpu_port):
    from portbench import harness

    rc, line, _ = harness.run_cell(name, 7_000_000_003, 0.5, False, cpu=True,
                                   control="reference_tf32", cell=small_cell(name))
    assert rc == 0 and line["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["console64-render", "console64-live"])
def test_the_programs_tf32_path_is_not_correct_on_the_card(name):
    """At the cell's own size, over a short window (runs on the card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 path exists only in cuBLAS and cuDNN")
    from portbench import harness, spec

    rc, line, _ = harness.run_cell(name, 7_000_000_005, 3.0, False,
                                   control="program_precision_default",
                                   cell=spec.cell(name, False))
    assert rc == 0 and line["correct"] is False
