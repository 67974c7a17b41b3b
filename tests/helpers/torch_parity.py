"""Shared pieces of the PyTorch port's parity tests against the JAX package.

The JAX side's variables come from the port's seeded random init through
``canonswap_tpu.runtime.weights.convert_*`` (the real-checkpoint path), so
both sides run the same weights; inputs are made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# ROADMAP's port tolerance (tests/test_reference_parity.py's)
RTOL = ATOL = 2e-4


@pytest.fixture(scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread for a module: the gate runs six test
    workers on the machine's cores, and each worker's default of one
    thread per core oversubscribes them (small TINY ops then spend their
    time waiting on one another)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def np_state_dict(module: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def jax_variables(module: torch.nn.Module, convert, **kw) -> dict:
    """The port module's weights as the JAX module's variable tree."""
    return convert(np_state_dict(module), **kw)


def randomized(variables, seed: int = 0) -> dict:
    """A JAX variable tree with every leaf drawn anew from ``seed``, so a
    parity test exercises each one (flax inits norms to 1/0 and PReLU to a
    constant): kernels LeCun normal over all but the last axis, biases and
    means N(0, 0.05^2), scales 1 + N(0, 0.1^2), PReLU slopes 0.25 +
    N(0, 0.1^2), variances U(0.5, 1.5)."""
    import jax

    g = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, name = np.shape(leaf), str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            value = g.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "var":
            value = 0.5 + g.random(shape)
        elif name == "scale":
            value = 1.0 + 0.1 * g.standard_normal(shape)
        elif name == "alpha":
            value = 0.25 + 0.1 * g.standard_normal(shape)
        else:
            value = 0.05 * g.standard_normal(shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


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


def _nchw_strided(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) laid out as NCHW in memory, so a net's permute to NCHW
    is contiguous (forward-mode GroupNorm refuses channels-last tangents)."""
    return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def crop_step_bound(net, crop_ref: np.ndarray, crop_got: np.ndarray,
                    pred: np.ndarray, scale: float) -> np.ndarray:
    """A bound on |d pred| per prediction when a landmark net's uint8 input
    crop moves by at most one grey level at some pixels (a cv2 stand-in's
    rounding): 2 * sum over the differing values i of |d pred_m / d x_i| *
    ``scale`` + 2e-4 * (1 + |pred_m|).  The derivatives are taken at the
    reference crop (first order; the factor 2 covers the kinks a
    one-grey-level step may cross), plus the port's tolerance.  ``scale``
    is the net's input step per grey level (1/255 for the 203-point
    runner, 1 for the 106-point runner's raw input); the net takes
    (B, H, W, 3) and treats each sample alone, so a batch of copies gives a
    chunk of the Jacobian at once: its columns at the differing values by
    forward mode where they are fewer than the predictions, else its rows
    by reverse mode."""
    from torch.func import jvp

    x = t(crop_ref.astype(np.float32) * scale)[None]
    differ = np.flatnonzero(crop_ref.reshape(-1) != crop_got.reshape(-1))
    total = torch.zeros(pred.size)
    if len(differ) <= pred.size:
        for chunk in np.array_split(differ, max(1, len(differ) // 64)):
            if not len(chunk):
                continue
            tangents = torch.zeros((len(chunk), x.numel()))
            tangents[torch.arange(len(chunk)), t(chunk)] = scale
            primal = _nchw_strided(x.expand(len(chunk), *x.shape[1:]))
            tangents = _nchw_strided(tangents.reshape(primal.shape))
            _, cols = jvp(net, (primal,), (tangents,))
            total += cols.abs().sum(0)
    else:
        for rows in np.array_split(np.arange(pred.size),
                                   max(1, pred.size // 32)):
            with torch.enable_grad():
                primal = _nchw_strided(x.expand(len(rows), *x.shape[1:]))
                primal.requires_grad_(True)
                out = net(primal)[torch.arange(len(rows)), t(rows)].sum()
                (grad,) = torch.autograd.grad(out, primal)
            total[t(rows)] = grad.reshape(len(rows), -1)[:, t(differ)].abs(
            ).sum(1) * scale
    return 2 * total.numpy() + 2e-4 * (1 + np.abs(pred))
