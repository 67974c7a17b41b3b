"""The adaptive (ID-modulated) conv of the swap module.

Port of ``canonswap_tpu/ops/modulated_conv.py::adaptive_blend_conv``.  The
modulated conv uses ``conv(x, w * style) == conv(x * style, w)``, so both
halves of the blend share one ordinary conv over the batch-stacked
``[x, x * style]``; demodulation is a per-(sample, out-channel) rescale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_blend_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    mask: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """``mask * out_mod + (1 - mask) * out_std``, stride 1, SAME padding.

    ``out_std`` is the plain conv with the shared weight; ``out_mod`` is the
    demodulated style conv plus ``bias`` (the standard half gets neither).

    x: (N, Cin, H, W); weight: (Cout, Cin, k, k); style: (N, Cin);
    mask: (N, 1, H, W) in [0, 1]; bias: (Cout,)."""
    n = x.shape[0]
    stacked = torch.cat([x, x * style[:, :, None, None]], dim=0)
    y = F.conv2d(stacked, weight, padding=weight.shape[-1] // 2)
    out_std, out_mod = y[:n], y[n:]
    w2 = (weight * weight).sum(dim=(2, 3))  # (Cout, Cin)
    demod = torch.rsqrt((style * style) @ w2.t() + 1e-8)  # (N, Cout)
    out_mod = out_mod * demod[:, :, None, None] + bias[None, :, None, None]
    return mask * out_mod + (1.0 - mask) * out_std
