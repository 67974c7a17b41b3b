"""Model hyper-parameters of the generator networks the port runs.

The fields of ``canonswap_tpu/configs/model_config.py`` (the reference's
``models.yaml``) that the ported networks read, with the same names, defaults
and presets; ``tests/test_torch_configs.py`` holds them equal.  The fast
bundle's options are here: ``WarpingConfig.dense_motion_scale`` and the
``int8_conv`` flags of appearance, swap and SPADE, with the JAX names, plus
``WarpingConfig.warp_quant``, the port's name for the JAX ``warp_impl``
value ``"pallas_quant"`` (the W8A8 warp); :func:`fast_bundle` sets them as
the JAX session does.  ``SpadeConfig.spectral_norm`` is the live spectral
norm for training from scratch (``nn/spectral.py``) and
:class:`StitchingConfig` the retargeting nets' sizes.  The JAX package's TPU
layouts and backends have no counterpart here, nor have the options the
fast bundle leaves off (``DenseMotionConfig.int8_conv``,
``SpadeConfig.norm_scale``) or that select another network than the
shipped checkpoint's: the port always estimates the occlusion map and
always ends the decoder in the 2x pixel-shuffle head (``upscale=2``).

:class:`ArgumentConfig` (the CLI), :class:`InferenceConfig` (the
session), :class:`CropConfig` (the Cropper) and :func:`partial_fields` are
the port's copy of ``canonswap_tpu/configs/pipeline_config.py``, field for
field, with the same defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional


@dataclasses.dataclass(frozen=True)
class AppearanceConfig:
    image_channel: int = 3
    block_expansion: int = 64
    num_down_blocks: int = 2
    max_features: int = 512
    reshape_channel: int = 32
    reshape_depth: int = 16
    num_resblocks: int = 6
    int8_conv: bool = False  # W8A8 3D resblock chain


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
    # >1: dense motion at 1/N in-plane resolution, field upsampled back
    dense_motion_scale: int = 1
    warp_quant: bool = False  # the W8A8 warp (JAX warp_impl="pallas_quant")
    dense_motion: DenseMotionConfig = dataclasses.field(
        default_factory=DenseMotionConfig)


@dataclasses.dataclass(frozen=True)
class SpadeConfig:
    block_expansion: int = 64
    max_features: int = 512
    num_down_blocks: int = 2
    out_channels: int = 64
    # live power-iteration spectral norm on the SPADE blocks' convs
    # (training from scratch); converted checkpoints have it baked in
    spectral_norm: bool = False
    int8_conv: bool = False  # W8A8 convs of G_middle_* and up_0, gated


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    latent_dim: int = 512
    n_blocks: int = 7  # adaptive 2D blocks
    n_resblocks_3d: int = 6
    # W8A8 adaptive convs (gated) and 3D chain; refine takes this flag too
    int8_conv: bool = False


@dataclasses.dataclass(frozen=True)
class StitchingConfig:
    # (input_size, hidden_sizes, output_size) per sub-net, models.yaml:31-43;
    # the input and output sizes are those of num_kp = 21
    stitching: tuple = (126, (128, 128, 64), 65)
    lip: tuple = (65, (128, 128, 64), 63)
    eye: tuple = (66, (256, 256, 128, 128, 64), 63)


@dataclasses.dataclass(frozen=True)
class CanonSwapModelConfig:
    appearance: AppearanceConfig = dataclasses.field(default_factory=AppearanceConfig)
    motion: MotionConfig = dataclasses.field(default_factory=MotionConfig)
    warping: WarpingConfig = dataclasses.field(default_factory=WarpingConfig)
    spade: SpadeConfig = dataclasses.field(default_factory=SpadeConfig)
    swap: SwapConfig = dataclasses.field(default_factory=SwapConfig)
    stitching: StitchingConfig = dataclasses.field(
        default_factory=StitchingConfig)
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


def fast_bundle(cfg: CanonSwapModelConfig) -> CanonSwapModelConfig:
    """``cfg`` with the JAX session's fast bundle (``InferenceConfig``
    ``dense_motion_scale=2, flag_int8=True``, ``pipelines/session.py``):
    half-resolution dense motion, W8A8 convs in appearance, swap (and so
    refine) and SPADE, and the W8A8 warp.  Same parameter tree as ``cfg``."""
    rep = dataclasses.replace
    return rep(
        cfg,
        warping=rep(cfg.warping, dense_motion_scale=2, warp_quant=True),
        appearance=rep(cfg.appearance, int8_conv=True),
        swap=rep(cfg.swap, int8_conv=True),
        spade=rep(cfg.spade, int8_conv=True),
    )


@dataclasses.dataclass
class ArgumentConfig:
    """The CLI's surface (the reference's argument_config.py:14-55)."""

    source: str = ""  # path to the source portrait (identity donor)
    driving: str = ""  # path to the target video/image (or .pkl template)
    output_dir: str = "results/"

    # inference flags
    flag_use_half_precision: bool = True  # bf16 generator on the card
    flag_crop_driving_video: bool = True
    flag_normalize_lip: bool = False
    flag_eye_retargeting: bool = False
    flag_lip_retargeting: bool = False
    flag_stitching: bool = False
    flag_relative_motion: bool = False
    flag_pasteback: bool = True
    flag_do_crop: bool = True
    # Kalman-smooth the motion template along the frame axis before the swap
    # pass (the reference's src/utils/filter.py:8-19, shipped but unwired
    # there); forces the two-pass (template-first) path
    flag_smooth_motion: bool = False
    audio_priority: Literal["source", "driving"] = "driving"

    # source crop args
    det_thresh: float = 0.15
    scale: float = 2.3
    vx_ratio: float = 0.0
    vy_ratio: float = -0.125
    flag_do_rot: bool = True
    source_max_dim: int = 4096
    source_division: int = 2

    # driving crop args
    scale_crop_driving_video: float = 2.2
    vx_ratio_crop_driving_video: float = 0.0
    vy_ratio_crop_driving_video: float = -0.1

    # the runtime's
    batch_size: int = 8  # frames per generator call
    checkpoint: Optional[str] = None  # combined_weights.pth (torch)
    stitching_checkpoint: Optional[str] = None
    dense_motion_scale: int = 1  # >1: half-res dense-motion speed mode
    flag_int8: bool = False  # W8A8 convs and the W8A8 warp
    spade_norm_scale: int = 1  # >1 is not in the port: the session raises
    warp_impl: str = "auto"  # the warp backend; the port has only "auto"
    # NaN/inf gate on every swapped batch (not in the port: the session
    # raises)
    debug_nans: bool = False
    # zero weights in place of the seeded ones (faster start); with
    # --checkpoint for real outputs, alone for timing the pipeline
    fast_init: bool = False


@dataclasses.dataclass
class InferenceConfig:
    """Runtime configuration (the reference's inference_config.py:19-69)."""

    flag_use_half_precision: bool = True
    flag_crop_driving_video: bool = False
    flag_normalize_lip: bool = True
    flag_eye_retargeting: bool = False
    flag_lip_retargeting: bool = False
    # stitching is off by default, as the reference's entry points force it
    # (inference_canswap.py:56)
    flag_stitching: bool = False
    flag_relative_motion: bool = False  # unsupported: the session raises
    flag_pasteback: bool = True
    flag_do_crop: bool = True
    flag_do_rot: bool = True
    flag_smooth_motion: bool = False

    source_max_dim: int = 1280
    source_division: int = 2
    input_shape: tuple[int, int] = (256, 256)
    output_format: Literal["mp4", "gif"] = "mp4"
    crf: int = 15
    output_fps: int = 25

    batch_size: int = 8
    checkpoint: Optional[str] = None
    # the stitching/retargeting checkpoint (.pth or .npz), for
    # flag_stitching / flag_*_retargeting
    stitching_checkpoint: Optional[str] = None
    # >1 estimates the dense deformation field at 1/N in-plane resolution
    # (exact at 1; the speed/quality knob)
    dense_motion_scale: int = 1
    # W8A8 int8 convs (ops/qconv.py) and the W8A8 warp
    flag_int8: bool = False
    # >1: SPADE up-block gamma/beta at 1/N output res (not in the port)
    spade_norm_scale: int = 1
    # the trilinear warp's backend: "auto" is the CUDA kernel on the card
    # (the W8A8 one under flag_int8), its plain version on the CPU
    warp_impl: str = "auto"
    # NaN/inf gate on every swapped batch (not in the port)
    debug_nans: bool = False


@dataclasses.dataclass
class CropConfig:
    """Crop geometry (the reference's crop_config.py:13-33)."""

    det_thresh: float = 0.1
    dsize: int = 512
    scale: float = 2.3
    vx_ratio: float = 0.0
    vy_ratio: float = -0.125
    max_face_num: int = 0
    flag_do_rot: bool = True
    scale_crop_driving_video: float = 2.2
    vx_ratio_crop_driving_video: float = 0.0
    vy_ratio_crop_driving_video: float = -0.1
    direction: str = "large-small"
    # animal-face landmarking through models/xpose (crop_config.py:27)
    animal_face_type: str = "animal_face_9"  # or "animal_face_68"


def partial_fields(target_class, kwargs: dict):
    """The entries of ``kwargs`` that name fields of the dataclass
    ``target_class``, as an instance of it (inference_canswap.py:14-15)."""
    names = {f.name for f in dataclasses.fields(target_class)}
    return target_class(**{k: v for k, v in kwargs.items() if k in names})
