"""Small cells for the CPU: a narrow VGG and a narrow ResNet registered in
the program's zoo for the test, a split of a few dozen images, and the
limits of the f32 cell."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NARROW_VGG = [8, "M", 16, "M", 16, 16, "M", 32, 32, "M", 32, 512, "M"]


def _json(kind, name):
    return json.loads((ROOT / kind / f"{name}.json").read_text())


@pytest.fixture
def narrow_models(monkeypatch):
    """The narrow VGG as ``vggnarrow`` and a narrow ResNet (one BasicBlock
    a stage, widths 8/16/32/512) as ``resnetnarrow`` in the program's zoo,
    for this test."""
    from cs744_ddp_tpu_torch import models
    from cs744_ddp_tpu_torch.models import resnet, vgg
    monkeypatch.setitem(vgg.CFG, "VGGNARROW", NARROW_VGG)
    monkeypatch.setitem(models.RESNETS, "resnetnarrow", "ResNetNarrow")
    monkeypatch.setitem(resnet.BLOCK_COUNTS, "ResNetNarrow", (1, 1, 1, 1))
    monkeypatch.setattr(resnet, "STAGES", ((8, 1), (16, 2), (32, 2),
                                           (512, 2)))


def small_spec(arch="vgg", precision="f32", world=1, batch=16, images=72,
               cell="vgg11_f32_single"):
    """A cell at CPU size: the real cell's limits and job, a narrow model
    (``narrow_models``) or, at world > 1, the full VGG-11, and a split of
    ``images`` images."""
    if arch == "vgg":
        config = _json("configs", "vgg11_bn_cifar10")
        if world == 1:
            config.update(layers=NARROW_VGG, port_model="vggnarrow")
    else:
        config = _json("configs", "resnet18_cifar10")
        config.update(widths=[8, 16, 32, 512],
                      blocks_per_stage=[1, 1, 1, 1],
                      port_model="resnetnarrow")
    traffic = _json("traffic", f"{precision}_single_b256")
    traffic.update(world=world, global_batch=batch,
                   strategy="single" if world == 1 else "ddp",
                   dataset={"recipe": "cifar10_synthetic",
                            "train_images": images, "test_images": 8})
    limits = _json("workloads", cell)["limits"]
    return {"name": "small", "config": config, "traffic": traffic,
            "cell": {"config": "small", "traffic": "small", "chips": world,
                     "limits": limits}, "root": ROOT}
