"""Seeded random weights for a module tree (no checkpoint ships).

Every parameter and buffer gets a value from one ``torch.Generator``, in
``state_dict`` order, so a seed gives the same weights on any device:

- conv / linear / adaptive-conv weights: LeCun normal, std 1/sqrt(fan_in);
- biases: N(0, 0.05^2);
- norm affines (BatchNorm, GroupNorm, LayerNorm): weight 1 + N(0, 0.1^2),
  bias N(0, 0.1^2); BatchNorm running mean N(0, 0.1^2), running var
  U(0.5, 1.5);
- GRN gamma / beta: N(0, 0.1^2).

Norm statistics and affines are random on purpose, so that a parity test
against another implementation exercises them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from canonswap_torch.nn.convnext import GRN

_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.GroupNorm,
          nn.LayerNorm)


def _value(module: nn.Module, name: str, shape, gen) -> torch.Tensor | None:
    def normal(std):
        return torch.randn(shape, generator=gen) * std

    if isinstance(module, _NORMS):
        if name == "weight":
            return 1.0 + normal(0.1)
        if name in ("bias", "running_mean"):
            return normal(0.1)
        if name == "running_var":
            return 0.5 + torch.rand(shape, generator=gen)
        return None  # num_batches_tracked
    if isinstance(module, GRN):
        return normal(0.1)
    if len(shape) >= 2:
        return normal(1.0 / math.sqrt(math.prod(shape[1:])))
    return normal(0.05)


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Fill ``module``'s parameters and float buffers in place from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    owners = dict(module.named_modules())
    for key, tensor in module.state_dict(keep_vars=True).items():
        owner_name, _, name = key.rpartition(".")
        value = _value(owners[owner_name], name, tuple(tensor.shape), gen)
        if value is not None:
            tensor.copy_(value)
    return module
