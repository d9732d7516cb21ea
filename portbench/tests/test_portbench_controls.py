"""On the card: each cell's control, the plain reference in the
precision below the cell's (TF32 for f32, fp8 for bf16) put in the
program's place, comes out not correct against the cell's limits, at the
cell's own size, on three seeds (the four-chip cell's reference works out
the four ranks in one process, so its control needs one card).  Skips
where there is no card."""

import tempfile

import pytest

from portbench import calibrate, check, run, worker

CELLS = ("vgg11_bf16_single", "resnet18_bf16_single", "vgg11_f32_single",
         "vgg11_bf16_ddp_w4")
SEEDS = (3100000003, 3100000019, 3100000037)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    spec = run.load_cell(cell)
    control = calibrate.CONTROL[spec["traffic"]["precision"]]
    for seed in SEEDS:
        with tempfile.TemporaryDirectory() as d:
            worker.make_data(spec, seed, d, card)
            ref = worker.reference_readings(spec, seed, d, card)
            low = worker.reference_readings(spec, seed, d, card, control)
        correct, rows = check.judge(check.numbers(low, ref),
                                    spec["cell"]["limits"])
        assert not correct, (seed, rows)
