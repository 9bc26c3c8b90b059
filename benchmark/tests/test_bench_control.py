"""What each cell's check catches, on the card at the cell's own size:
``python -m pytest benchmark/tests -m card`` on a machine with a card.

Each cell's control (the program at bfloat16 for the serving and train
cells; the reference at TF32 in the CLI's place) comes out not correct on
three seeds, and the program correct. The faults that the training
numbers are held against come out not correct too."""

import pytest

from benchmark import faults
from benchmark.readings import readings

SEEDS = [4100000001, 4100000002, 4100000003]
TRAIN = "stereo.train.balanced16"
CELLS = ["stereo.serve.balanced16", "zero.serve.balanced", "stereo.cli.float32", TRAIN]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes(card, cell):
    (sound,) = readings(cell, [4100000004], 1.0, False, card)
    assert sound["ok"], sound


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(card, cell):
    controls = readings(cell, SEEDS, 1.0, True, card)
    assert not any(r["ok"] for r in controls), controls


@pytest.mark.card
@pytest.mark.parametrize("fault", faults.TRAIN)
def test_train_faults_fail(card, fault):
    broken = readings(TRAIN, SEEDS, 1.0, False, card, fault)
    assert not any(r["ok"] for r in broken), broken
