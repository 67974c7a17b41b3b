"""The port's model configs match the JAX package's, field for field."""

from __future__ import annotations

import dataclasses

import pytest

from canonswap_tpu.configs import model_config as J
from canonswap_torch import configs as P

SUBCONFIGS = ["appearance", "motion", "warping", "warping.dense_motion",
              "spade", "swap"]


def _get(cfg, path: str):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


@pytest.mark.parametrize("preset", ["CANONICAL", "TINY"])
@pytest.mark.parametrize("path", SUBCONFIGS)
def test_fields_match_the_jax_config(preset, path):
    port, ref = _get(getattr(P, preset), path), _get(getattr(J, preset), path)
    for f in dataclasses.fields(port):
        if dataclasses.is_dataclass(getattr(port, f.name)):
            continue  # compared under its own path
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("preset", ["CANONICAL", "TINY"])
def test_sizes_match_the_jax_config(preset):
    port, ref = getattr(P, preset), getattr(J, preset)
    assert (port.input_size, port.output_size) == (ref.input_size,
                                                   ref.output_size)


def test_jax_options_the_port_lacks_are_off():
    """The JAX presets set the options the port does not have as the port
    runs: full-resolution dense motion, the occlusion map, the 2x
    pixel-shuffle head, no int8."""
    for cfg in (J.CANONICAL, J.TINY):
        assert cfg.warping.dense_motion_scale == 1
        assert cfg.warping.estimate_occlusion_map and cfg.spade.upscale == 2
        assert not any((cfg.appearance.int8_conv, cfg.spade.int8_conv,
                        cfg.swap.int8_conv,
                        cfg.warping.dense_motion.int8_conv))
        assert cfg.spade.norm_scale == 1 and not cfg.spade.spectral_norm
