"""The Moonlight-16B-A3B cell's files on the CPU: the architecture
plug-in's MACs against a hand count at the cell's widths, the token
recipe's files, and the three metrics on a fabricated traced epoch.  The
program's CPU tests (tests/test_torch_port_moonlight.py) hold the program
against the plug-in's forward and gradients."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import plugins, run, yardstick
from portbench.reference import steps as refsteps

ROOT = Path(__file__).resolve().parents[1]
CELL = "moonlight_ep8_bf16_s8192"
def _arch():
    return plugins.load("arch", "moonlight")


def test_macs_per_sequence_by_hand():
    """At the cell's widths and 8,192 positions, term by term a token:
    the attention's projections 13,762,560 (q 2048x3072, kv_a 2048x576,
    kv_b 512x4096, o 2048x2048), its scores and values
    16 x (192 + 128) x 8193 / 2 at each of 9 layers, the dense SwiGLU
    3 x 2048 x 11264, the shared experts 3 x 2048 x 2816 and the router
    2048 x 64 at each of 8 layers, the routed experts 3 x 2048 x 1408 x
    6 x 8 / 64 at each of 8, the head 2048 x 20480: about 615 M MACs."""
    spec = run.load_cell(CELL)
    config, traffic = spec["config"], spec["traffic"]
    arch = _arch()
    attention = 9 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    scores = 9 * 16 * (192 + 128) * 8193 / 2
    dense = 3 * 2048 * 11264
    shared = 8 * 3 * 2048 * 2816
    router = 8 * 2048 * 64
    routed = 8 * 3 * 2048 * 1408 * 6 * 8 / 64
    head = 2048 * 20480
    per_token = attention + scores + dense + shared + router + routed + head
    assert 614e6 < per_token < 616e6
    assert arch.macs_per_example(config, traffic) == round(per_token * 8192)
    assert arch.macs_per_example_unrouted(config, traffic) == \
        round((per_token - routed) * 8192)
    assert arch.routed_macs_per_row(config) == 3 * 2048 * 1408
    assert yardstick.model_flops_per_image(config, traffic) == \
        6 * round(per_token * 8192)


def test_recipe_round_trips(tmp_path):
    """``make`` writes what the program reads (tokens/train.npy and
    test.npy, int32 [N, S + 1]); ``read`` gives it back; ``batch`` gives
    inputs and next-token targets; the same seed draws the same ids and
    the frequent ids follow the Zipf law."""
    recipe = plugins.load("recipes", "tokens_zipf")
    dataset = {"recipe": "tokens_zipf", "seq_len": 63, "vocab": 512,
               "zipf_s": 1.0, "train_sequences": 40, "test_sequences": 3}
    recipe.make(dataset, 2 ** 31 + 5, str(tmp_path), "cpu")
    train = np.load(tmp_path / "tokens" / "train.npy")
    test = np.load(tmp_path / "tokens" / "test.npy")
    assert train.dtype == np.int32 and train.shape == (40, 64)
    assert test.shape == (3, 64)
    assert np.array_equal(recipe.read(str(tmp_path)), train)
    assert np.array_equal(train, recipe.sequences(40, dataset, 2 ** 31 + 5))
    assert train.min() >= 0 and train.max() < 512
    counts = np.sort(np.bincount(train.reshape(-1), minlength=512))[::-1]
    # Rank 1 against rank 2 under s = 1: about twice as frequent.
    assert 1.6 < counts[0] / counts[1] < 2.5
    assert recipe.examples(dataset) == 40
    traffic = {"augment": False}
    x, y = recipe.batch(train, np.array([3, 1]), traffic, 0, 0, 0, "cpu")
    assert torch.equal(x, torch.from_numpy(train[[3, 1], :-1]).long())
    assert torch.equal(y, torch.from_numpy(train[[3, 1], 1:]).long())
    with pytest.raises(ValueError, match="augment false"):
        recipe.batch(train, np.array([0]), {"augment": True}, 0, 0, 0, "cpu")


def _ctx(counters, kernels, rate=10.0):
    spec = run.load_cell(CELL)
    trace = {"counters": counters, "kernels": kernels, "families": {},
             "busy_us": 0.0, "wall_us": 1.0, "gaps": {}}
    return run.Context(spec, rate, [trace], 6, 120)


def test_metrics_read_a_fabricated_trace():
    """Each new metric on counters and kernel times made up by hand; none
    where the program has no expert counters or no such kernels."""
    metrics = run.load_metrics(ROOT)
    flops = 2 * 4608 * 8 * 2048 * 2816 * 5
    kernels = {"void cutlass::device_kernel<cutlass::gemm::kernel::"
               "GemmUniversal<cutlass::gemm::GroupProblemShape<cute::tuple"
               "<int, int, int> >, X>": [2900.0, 60],
               "void at::cuda::detail::prepare_grouped_gemm_data<Y>":
                   [100.0, 60],
               "void pytorch_flash::flash_fwd_kernel<X>": [30000.0, 180],
               "void pytorch_flash::flash_bwd_dq_dk_dv_loop_kernel<Y>":
                   [70000.0, 180],
               "ampere_sgemm": [5.0, 1]}
    rows = 20 * 8 * 36864
    ctx = _ctx({"moe": {"flops": flops, "rows": rows}}, kernels)
    got = metrics["grouped_mm_roofline_pct.train"].read(ctx)
    assert got == pytest.approx(100 * flops / (3000e-6 * 989.4e12))
    got = metrics["attention_ms_per_step.train"].read(ctx)
    assert got == pytest.approx(100000.0 / 1e3 / 20)
    # 10 sequences a second; a step of 6 sequences holds 8 x 36,864 held
    # rows, 49,152 held rows a sequence.
    unrouted = (9 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
                + 9 * 16 * 320 * 8193 / 2 + 3 * 2048 * 11264
                + 8 * 3 * 2048 * 2816 + 8 * 2048 * 64 + 2048 * 20480) * 8192
    per_seq = round(unrouted) + 3 * 2048 * 1408 * 8 * 36864 / 6
    got = metrics["mfu_routed.train"].read(ctx)
    assert got == pytest.approx(100 * 10.0 * 6 * per_seq / 989.4e12)
    empty = _ctx({"moe": {"flops": 0, "rows": 0}}, {"ampere_sgemm": [5, 1]})
    for name in ("grouped_mm_roofline_pct.train",
                 "attention_ms_per_step.train", "mfu_routed.train"):
        assert metrics[name].read(empty) is None
        assert metrics[name].read(_ctx({}, {})) is None


def test_cell_refuses_a_parent_without_the_plugin(tmp_path):
    """A checkout whose harness lacks ``arch/moonlight.py`` fails the cell
    at once: the plug-in is loaded before any work."""
    spec = run.load_cell(CELL)
    spec["root"] = tmp_path
    with pytest.raises(ValueError, match="no arch plug-in 'moonlight'"):
        plugins.cell(spec)


def test_reference_chunks_one_sequence():
    """The traffic's reference_chunk_rows (1) is taken for this
    architecture, which keeps no batch statistics."""
    spec = run.load_cell(CELL)
    assert refsteps.chunk_rows(_arch(), spec["traffic"]) == 1
