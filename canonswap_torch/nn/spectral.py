"""Live spectral normalization (training from scratch).

Port of ``canonswap_tpu/nn/spectral.py``.  Converted checkpoints carry
spectral norm baked into the SPADE convs' weights; training from scratch
(``SpadeConfig.spectral_norm``) normalizes them live: one power iteration
per forward on the stored vector ``u``, eps 1e-12, the weight divided by
sigma.  As in the JAX function, sigma is differentiated through the weight
along every path (through the iteration's ``v`` and new ``u`` too); the new
``u`` itself carries no gradient.  ``u`` is a buffer, advanced in place
under no_grad in training mode (the JAX module's mutable ``spectral``
collection), and only read in eval mode.

The weight is flattened as torch's (out, in * kh * kw), where the JAX
package flattens (kh * kw * in, out).T: sigma and the new ``u`` do not
depend on the order of the columns.
"""

from __future__ import annotations

import torch
from torch import nn


def _l2norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor,
                       n_iter: int = 1):
    """(weight / sigma, u_new) with ``n_iter`` power iterations from ``u``
    on weight (out, ...) flattened to (out, -1); u_new is detached."""
    w = weight.reshape(weight.shape[0], -1).float()
    u = u.float()
    for _ in range(n_iter):
        v = _l2norm(w.T @ u)
        u = _l2norm(w @ v)
    sigma = u @ (w @ v)
    return weight / sigma.to(weight.dtype), u.detach()


class SNConv2d(nn.Conv2d):
    """A stride-1 SAME ``nn.Conv2d`` (odd kernel) with live spectral norm:
    ``weight`` and ``bias`` keep the conv's names, ``u`` (out,) is the
    power-iteration vector."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, bias=bias)
        self.register_buffer("u", _l2norm(torch.randn(out_channels)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, u_new = spectral_normalize(self.weight, self.u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u_new)
        return self._conv_forward(x, w, self.bias)
