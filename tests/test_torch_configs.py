"""The port's model configs match the JAX package's, field for field."""

from __future__ import annotations

import dataclasses

import pytest

from canonswap_torch import configs as P
from canonswap_torch.models import parsing as PP
from canonswap_tpu.configs import model_config as J
from canonswap_tpu.models import parsing as JP

SUBCONFIGS = ["appearance", "motion", "warping", "warping.dense_motion",
              "spade", "swap", "stitching"]


def _get(cfg, path: str):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


def _ref_value(ref, name: str):
    """The JAX field a port field stands for: ``warp_quant`` is the port's
    name for ``warp_impl == "pallas_quant"`` (JAX's names are TPU backends)."""
    if name == "warp_quant":
        return ref.warp_impl == "pallas_quant"
    return getattr(ref, name)


@pytest.mark.parametrize("preset", ["CANONICAL", "TINY"])
@pytest.mark.parametrize("path", SUBCONFIGS)
def test_fields_match_the_jax_config(preset, path):
    port, ref = _get(getattr(P, preset), path), _get(getattr(J, preset), path)
    for f in dataclasses.fields(port):
        if dataclasses.is_dataclass(getattr(port, f.name)):
            continue  # compared under its own path
        assert getattr(port, f.name) == _ref_value(ref, f.name), f.name


@pytest.mark.parametrize("preset", ["CANONICAL", "TINY"])
def test_sizes_match_the_jax_config(preset):
    port, ref = getattr(P, preset), getattr(J, preset)
    assert (port.input_size, port.output_size) == (ref.input_size,
                                                   ref.output_size)


def test_jax_options_the_port_lacks_are_off():
    """The JAX presets set the options the port does not have as the port
    runs: the occlusion map, the 2x pixel-shuffle head, no int8 dense
    motion, no SPADE norm_scale; and no live spectral norm, which the port
    has (off by default, as in the JAX presets)."""
    for cfg in (J.CANONICAL, J.TINY):
        assert cfg.warping.estimate_occlusion_map and cfg.spade.upscale == 2
        assert not cfg.warping.dense_motion.int8_conv
        assert cfg.spade.norm_scale == 1 and not cfg.spade.spectral_norm


@pytest.mark.parametrize("port,ref", [
    (PP.SegformerConfig(), JP.SegformerConfig()),
    (PP.TINY, JP.SegformerConfig(hidden_sizes=(16, 24, 40, 64),
                                 depths=(1, 1, 1, 1), num_heads=(1, 2, 5, 8),
                                 decoder_hidden=64))], ids=["MiT-B1", "TINY"])
def test_segformer_config_matches_the_jax_dataclass(port, ref):
    """Field for field, names in order; TINY is test_parsing_parity.py's."""
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
