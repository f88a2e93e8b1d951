"""On the card: the control (the reference computed with TF32 allowed,
put in the program's place) fails a limit, and the program's own steps
pass them all, on lego.scenes4's scenes at their own size (run on the chip:
python3 -m pytest splatbench/tests -m cuda)."""
import pytest
import torch

from splatbench import calibrate, correctness, harness


@pytest.mark.cuda
def test_control_fails_and_program_passes(card):
    cell = harness.load_cell("lego.scenes4")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = harness.program()
    seed = 2**31 + 7
    readings, views, job = calibrate.program_readings(cell, seed, card, prog)
    train = cell.config["train"]
    ref = correctness.reference_readings(
        harness.reference_scenes(cell, job, card, views), train)
    ctl = correctness.reference_readings(
        harness.reference_scenes(cell, job, card, views), train, tf32=True)
    sound = correctness.compare(readings, ref)
    control = correctness.compare(ctl, ref)
    assert all(sound[k] <= cell.limits[k] for k in sound), sound
    assert any(control[k] > cell.limits[k] for k in control), control
