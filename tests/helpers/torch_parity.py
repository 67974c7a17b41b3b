"""Shared pieces of the PyTorch port's parity tests against the JAX package.

The JAX side's variables come from the port's seeded random init through
``canonswap_tpu.runtime.weights.convert_*`` (the real-checkpoint path), so
both sides run the same weights; inputs are made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np
import torch

# ROADMAP's port tolerance (tests/test_reference_parity.py's)
RTOL = ATOL = 2e-4


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def np_state_dict(module: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def jax_variables(module: torch.nn.Module, convert, **kw) -> dict:
    """The port module's weights as the JAX module's variable tree."""
    return convert(np_state_dict(module), **kw)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def ndhwc_to_ncdhw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def ncdhw_to_ndhwc(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def assert_close(got, want, rtol: float = RTOL, atol: float = ATOL) -> None:
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)
