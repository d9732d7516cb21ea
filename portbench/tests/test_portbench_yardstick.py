"""The yardstick's counts against hand counts, and the trace arithmetic on
made-up intervals."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import trace, yardstick

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
TRAFFIC = json.loads((ROOT / "traffic" / "bf16_single_b256.json").read_text())


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_vgg11_flops_hand_count():
    # Per image: conv MACs cin*9*cout*h*w at 32, 16, 8, 8, 4, 4, 2, 2.
    convs = [(3, 64, 32), (64, 128, 16), (128, 256, 8), (256, 256, 8),
             (256, 512, 4), (512, 512, 4), (512, 512, 2), (512, 512, 2)]
    macs = sum(ci * 9 * co * h * h for ci, co, h in convs) + 512 * 10
    assert macs == 152_769_536
    cfg = _config("vgg11_bn_cifar10")
    assert yardstick.model_macs_per_image(cfg, TRAFFIC) == macs
    assert yardstick.model_flops_per_image(cfg, TRAFFIC) == 916_617_216


def test_resnet18_flops_hand_count():
    stem = 3 * 9 * 64 * 32 * 32
    stage1 = 4 * (64 * 9 * 64 * 32 * 32)

    def stage(cin, cout, h):      # h: the stage's output size
        return (cin * 9 * cout * h * h + 3 * (cout * 9 * cout * h * h)
                + cin * cout * h * h)

    macs = stem + stage1 + stage(64, 128, 16) + stage(128, 256, 8) \
        + stage(256, 512, 4) + 512 * 10
    assert macs == 555_422_720
    cfg = _config("resnet18_cifar10")
    assert yardstick.model_macs_per_image(cfg, TRAFFIC) == macs
    assert yardstick.model_flops_per_image(cfg, TRAFFIC) == 3_332_536_320


@pytest.mark.parametrize("batch,precision,want", [
    (256, "f32", 287_863_552), (256, "bf16", 143_946_496),
    (64, "f32", 71_987_968), (64, "bf16", 36_008_704)])
def test_bnpool_bytes(batch, precision, want):
    # Pre-pool activations of the five pool blocks, elements an image.
    per_image = 64 * 32 * 32 + 128 * 16 * 16 + 256 * 8 * 8 + 512 * 4 * 4 \
        + 512 * 2 * 2
    item = {"f32": 4, "bf16": 2}[precision]
    vectors = 5 * 4 * (64 + 128 + 256 + 512 + 512)
    hand = batch * per_image * item * 9 // 4 + vectors
    assert hand == want
    cfg = _config("vgg11_bn_cifar10")
    assert yardstick.bnpool_bwd_bytes(cfg, batch, precision) == want
    if batch == 256:
        assert round(want / 1e6, 1) == {"f32": 287.9, "bf16": 143.9}[
            precision]


def test_resnet_has_no_pool_block_bytes():
    assert yardstick.bnpool_bwd_bytes(_config("resnet18_cifar10"), 256,
                                      "bf16") == 0


def test_busy_us_is_the_union():
    assert yardstick.busy_us([]) == 0.0
    assert yardstick.busy_us([(0, 10), (5, 15), (20, 25)]) == 20.0
    assert yardstick.busy_us([(20, 25), (0, 10), (10, 12)]) == 17.0


def test_family_split():
    fams = yardstick.family_us([
        ("void sums_kernel<float>(...)", 3.0), ("ncclDevKernel_AllReduce", 2),
        ("cudnn::bn_fw_tr_1C11_kernel_NCHW", 4.0),
        ("sm90_xmma_fprop_implicit_gemm", 10.0),
        ("void at::native::vectorized_elementwise_kernel", 1.5),
        ("Memcpy DtoH (Device -> Pinned)", 0.5), ("mystery", 1.0)])
    assert fams == {"bnpool kernels": 3.0, "collectives": 2,
                    "batch norm": 4.0, "convolution": 10.0,
                    "elementwise": 1.5, "copy": 0.5, "other": 1.0}


class _Event(SimpleNamespace):
    def name(self):
        return self.n

    def start_ns(self):
        return self.s * 1000

    def duration_ns(self):
        return (self.e - self.s) * 1000

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.gpu else DeviceType.CPU

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return 0


def test_summarize_names_the_gaps():
    ev = [_Event(n="portbench.window", s=0, e=100, gpu=False, c=0),
          _Event(n="portbench.epoch", s=0, e=90, gpu=False, c=0),
          _Event(n="portbench.rank_barrier", s=90, e=100, gpu=False, c=0),
          _Event(n="cudaGraphLaunch", s=1, e=2, gpu=False, c=7),
          _Event(n="cudaLaunchKernel", s=40, e=41, gpu=False, c=8),
          _Event(n="sm90_xmma_fprop", s=10, e=30, gpu=True, c=7),
          _Event(n="sums_kernel<float>", s=25, e=35, gpu=True, c=7),
          _Event(n="elementwise_kernel", s=50, e=60, gpu=True, c=8),
          _Event(n="outside", s=150, e=160, gpu=True, c=8)]
    got = trace.summarize(ev)
    assert got["wall_us"] == 100 and got["busy_us"] == 35
    assert got["families"] == {"convolution": 20, "bnpool kernels": 10,
                               "elementwise": 10}
    assert got["gaps"] == {"epoch: idle before graph replay": [10, 1],
                           "epoch: idle before eager kernel": [15, 1],
                           "epoch: idle before window end": [40, 1]}
    b = trace.breakdown(got)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0] == ["epoch: idle before window end (x1)",
                                 40e-6]
