"""Model hyper-parameters of the generator networks the port runs.

The fields of ``canonswap_tpu/configs/model_config.py`` (the reference's
``models.yaml``) that the ported networks read, with the same names, defaults
and presets; ``tests/test_torch_configs.py`` holds them equal.  The JAX
package's TPU layout and int8 options have no counterpart here.  Nor have
the options that select another network than the shipped checkpoint's: the
port runs dense motion at full resolution (``dense_motion_scale=1``), always
estimates the occlusion map and always ends the decoder in the 2x
pixel-shuffle head (``upscale=2``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AppearanceConfig:
    image_channel: int = 3
    block_expansion: int = 64
    num_down_blocks: int = 2
    max_features: int = 512
    reshape_channel: int = 32
    reshape_depth: int = 16
    num_resblocks: int = 6


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    num_kp: int = 21
    num_bins: int = 66
    depths: tuple[int, ...] = (3, 3, 9, 3)
    dims: tuple[int, ...] = (96, 192, 384, 768)


@dataclasses.dataclass(frozen=True)
class DenseMotionConfig:
    block_expansion: int = 32
    max_features: int = 1024
    num_blocks: int = 5
    reshape_depth: int = 16
    compress: int = 4


@dataclasses.dataclass(frozen=True)
class WarpingConfig:
    num_kp: int = 21
    block_expansion: int = 64
    max_features: int = 512
    num_down_blocks: int = 2
    reshape_channel: int = 32
    dense_motion: DenseMotionConfig = dataclasses.field(
        default_factory=DenseMotionConfig)


@dataclasses.dataclass(frozen=True)
class SpadeConfig:
    block_expansion: int = 64
    max_features: int = 512
    num_down_blocks: int = 2
    out_channels: int = 64


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    latent_dim: int = 512
    n_blocks: int = 7  # adaptive 2D blocks
    n_resblocks_3d: int = 6


@dataclasses.dataclass(frozen=True)
class CanonSwapModelConfig:
    appearance: AppearanceConfig = dataclasses.field(default_factory=AppearanceConfig)
    motion: MotionConfig = dataclasses.field(default_factory=MotionConfig)
    warping: WarpingConfig = dataclasses.field(default_factory=WarpingConfig)
    spade: SpadeConfig = dataclasses.field(default_factory=SpadeConfig)
    swap: SwapConfig = dataclasses.field(default_factory=SwapConfig)
    input_size: int = 256  # model input crop
    output_size: int = 512


# the shipped checkpoint's widths
CANONICAL = CanonSwapModelConfig()

# same topology and depth counts, narrow widths, 64x64 inputs: for CPU tests
TINY = CanonSwapModelConfig(
    appearance=AppearanceConfig(
        block_expansion=16, max_features=64, reshape_channel=8,
        reshape_depth=8, num_resblocks=1,
    ),
    motion=MotionConfig(num_kp=5, depths=(1, 1, 2, 1), dims=(16, 24, 32, 48)),
    warping=WarpingConfig(
        num_kp=5, block_expansion=16, max_features=64, reshape_channel=8,
        dense_motion=DenseMotionConfig(
            block_expansion=8, max_features=64, num_blocks=2, reshape_depth=8,
            compress=2,
        ),
    ),
    spade=SpadeConfig(block_expansion=16, max_features=64, out_channels=16),
    swap=SwapConfig(latent_dim=32, n_blocks=2, n_resblocks_3d=1),
    input_size=64,
    output_size=128,
)
