"""The port's weights: the round trip through the JAX package's converters,
the seeded init, and a port that imports without JAX."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from canonswap_tpu.runtime import weights as JW
from canonswap_torch.configs import TINY
from canonswap_torch.runtime import core as C
from canonswap_torch.runtime.weights import FROM_JAX, from_jax
from tests.helpers.torch_parity import np_state_dict

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def core():
    return C.CanonSwapCore(TINY, seed=0)


@pytest.mark.parametrize("net", sorted(FROM_JAX))
def test_round_trip_through_convert(core, net):
    """port state_dict -> convert_* -> from_jax gives it back exactly."""
    sd = getattr(core, net).state_dict()
    back = FROM_JAX[net](JW._CONVERTERS[net](np_state_dict(getattr(core, net))))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def test_from_jax_loads_the_whole_core_strictly(core):
    variables = {net: JW._CONVERTERS[net](np_state_dict(getattr(core, net)))
                 for net in FROM_JAX}
    fresh = C.CanonSwapCore(TINY, seed=None)
    fresh.load_state_dict(from_jax(variables), strict=True)
    for k, v in core.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_seeded_init(core):
    same = C.CanonSwapCore(TINY, seed=0).state_dict()
    other = C.CanonSwapCore(TINY, seed=1).state_dict()
    sd = core.state_dict()
    assert all(torch.equal(sd[k], same[k]) for k in sd)
    assert not torch.equal(sd["refine.resblocks1.0.conv1.weight"],
                           other["refine.resblocks1.0.conv1.weight"])
    # norm statistics and affines are random, so parity tests exercise them
    var = sd["appearance_feature_extractor.first.norm.running_var"]
    assert float(var.min()) >= 0.5 and not torch.allclose(var, torch.ones_like(var))
    assert not torch.allclose(sd["refine.resblocks1.0.gn1.weight"],
                              torch.ones(TINY.appearance.reshape_channel))
    assert not core.training
    assert not any(p.requires_grad for p in core.parameters())


def test_port_imports_without_jax():
    """Neither jax, flax nor the JAX package is reached: the card's machine
    has no jax, and the port stands alone."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['canonswap_tpu'] = None\n"
        "import canonswap_torch\n"
        "from canonswap_torch.runtime import core, weights\n"
        "from canonswap_torch.ops.cuda import warp\n"
        "from canonswap_torch.configs import TINY\n"
        "core.CanonSwapCore(TINY)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
