"""Layers of the model zoo, with the reference training script's torch
semantics and PyTorch-default initialization.

  * ``Conv2d``, ``Linear``: compute follows the ACTIVATION dtype, as the
    reference package's ``conv2d_apply``/``linear_apply``: the master
    weight and bias stay f32 and are cast to ``x.dtype`` at the point of
    use (no copy for f32 input), so bf16 activations run a bf16 conv or
    matmul while gradients, momentum and comm state stay f32.
    ``conv2d`` makes any kernel size, stride, padding, with or without a
    bias (the ResNet's bias-free 3x3 and 1x1 convs); ``conv3x3`` is the
    VGG's (pad 1, bias).
  * ``batchnorm``: library BatchNorm2d for the blocks without a pool —
    normalize with the biased batch variance, update the running statistics
    with the unbiased variance at momentum 0.1.  With bf16 input and f32
    parameters it normalizes in f32, returns bf16 and keeps its running
    statistics f32.
  * ``BnReluPool2d``: BatchNorm2d -> ReLU -> MaxPool2x2 for the blocks that
    end in a pool, with the same parameters, buffers and running-statistics
    rule; in training it runs the fused op (``ops/bnpool.py``), whose
    backward is the CUDA kernels on the GPU.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bnpool import BN_EPS, BnReluPool

BN_MOMENTUM = 0.1


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the activation's dtype, with or without a
    bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def conv2d(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
           padding: int = 1, bias: bool = True) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel_size=kernel_size, stride=stride,
                  padding=padding, bias=bias)


def conv3x3(in_ch: int, out_ch: int) -> Conv2d:
    return conv2d(in_ch, out_ch)


def batchnorm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def linear(in_features: int, out_features: int) -> Linear:
    return Linear(in_features, out_features)


class BnReluPool2d(nn.BatchNorm2d):
    """BatchNorm2d -> ReLU -> MaxPool2d(2, 2) as one module.

    Training runs ``BnReluPool`` and updates the running statistics from its
    batch statistics; evaluation uses the running statistics and the plain
    library chain (no backward, so no kernel)."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return F.max_pool2d(F.relu(y), kernel_size=2, stride=2)
        pooled, mean, var = BnReluPool.apply(x, self.weight, self.bias)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            unbiased = var * (n / max(n - 1, 1))
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
            self.num_batches_tracked.add_(1)
        return pooled


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """PyTorch-default initialization drawn from ``generator``: conv and
    linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (what
    ``kaiming_uniform_(a=sqrt(5))`` reduces to); BatchNorm gamma 1, beta 0,
    running mean 0, running var 1.  A module with a ``draw_parameters``
    method draws its own tensors from ``generator`` instead (the
    Moonlight layers: ``models/moonlight.py``), in the same module order."""
    for m in module.modules():
        if hasattr(m, "draw_parameters"):
            m.draw_parameters(generator)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / (m.weight[0].numel() ** 0.5)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
