"""FaceSwapSession: every component of the swap stack, built once.

The port's counterpart of ``canonswap_tpu/pipelines/session.py`` (the
reference's CanSwapPipeline.__init__, can_swap_pipeline_e2e.py:39-57): the
generator core, the Cropper (SCRFD, the 106- and 203-point landmark
runners), face parsing, the ID cropper and ArcFace, on one device, with the
JAX session's batched entry points.  Under ``flag_stitching``,
``flag_eye_retargeting`` or ``flag_lip_retargeting`` it also holds the
stitching and retargeting nets (f32), and the swap adjusts the driving
keypoints (``runtime/core.py::adjust_driving_kp``).

The generator runs in bf16 under ``flag_use_half_precision`` (keypoint math
stays f32); the sidecars run in f32.  Weights are seeded (no checkpoint
ships): the components, in the order core, SCRFD, the 203-point tracker,
the 106-point net, ArcFace, Segformer and the stitching nets, take ``seed``
plus :data:`SEED_OFFSETS`; at seed 0 these are the seeds ``chip_smoke.py``'s
clip path has always run.  ``fast_init`` gives zero weights instead, as
the JAX session's ``eval_shape`` zeros do.
"""

from __future__ import annotations

import dataclasses

import torch

from canonswap_torch.configs import (CANONICAL, CanonSwapModelConfig,
                                     CropConfig, InferenceConfig)
from canonswap_torch.models import parsing as P
from canonswap_torch.models.arcface import ArcFaceRunner
from canonswap_torch.models.landmark import (Landmark106Runner,
                                             Landmark203Runner)
from canonswap_torch.models.stitching import StitchingModule
from canonswap_torch.nn.init import init_random_
from canonswap_torch.runtime import core as C
from canonswap_torch.runtime.cropper import Cropper
from canonswap_torch.runtime.device import on_device, resolve_device
from canonswap_torch.runtime.face_analysis import (FaceAnalysis,
                                                   FaceIDCropper, source_id)

# each component's seed is seed + its offset
SEED_OFFSETS = {"core": 0, "scrfd": 0, "landmark203": 1, "landmark106": 3,
                "arcface": 4, "parsing": 0, "stitching": 6}


@torch.no_grad()
def _zero_(module: torch.nn.Module) -> None:
    for value in module.state_dict().values():
        if value.is_floating_point():
            value.zero_()


def _model_config(cfg: InferenceConfig,
                  model_cfg: CanonSwapModelConfig) -> CanonSwapModelConfig:
    """The generator's configuration under the session's flags
    (``session.py:63-113``), or a raise for a flag the port does not
    have."""
    if cfg.flag_relative_motion:
        raise ValueError(
            "flag_relative_motion is not supported by the e2e swap path "
            "(the reference never consumes it either: it swaps per-frame "
            "absolute motion; see SURVEY.md §2a)")
    if cfg.debug_nans:
        raise NotImplementedError(
            "debug_nans is not in the port yet (ROADMAP A 8)")
    if cfg.spade_norm_scale > 1:
        raise ValueError(
            "spade_norm_scale > 1 is left out of the port on purpose "
            "(ROADMAP 'Left out of the port'): it is not in the fast bundle")
    if cfg.warp_impl != "auto":
        raise ValueError(
            f"warp_impl={cfg.warp_impl!r}: the port has one warp per device, "
            "'auto' (the CUDA kernel on the card, the W8A8 one under "
            "flag_int8; their plain versions on the CPU); 'packed', "
            "'pallas' and 'pallas_quant' are the JAX package's TPU backends")
    rep = dataclasses.replace
    if cfg.dense_motion_scale > 1:
        model_cfg = rep(model_cfg, warping=rep(
            model_cfg.warping, dense_motion_scale=cfg.dense_motion_scale))
    if cfg.flag_int8:
        model_cfg = rep(
            model_cfg,
            appearance=rep(model_cfg.appearance, int8_conv=True),
            swap=rep(model_cfg.swap, int8_conv=True),
            spade=rep(model_cfg.spade, int8_conv=True),
            warping=rep(model_cfg.warping, warp_quant=True))
    return model_cfg


def load_core_checkpoint(core: C.CanonSwapCore, path: str) -> None:
    """The reference's ``combined_weights.pth`` (torch alone), or a ``.npz``
    written by ``python -m canonswap_tpu.cli.convert combined`` (its
    '/'-flattened JAX trees, through ``runtime/weights.py::from_jax``, numpy
    alone), into ``core`` with strict keys.  Other formats (the JAX
    package's ``.msgpack``) raise."""
    from canonswap_torch.runtime import weights as W
    from canonswap_torch.runtime.checkpoint import load_npz

    if path.endswith(".npz"):
        sd = W.from_jax(load_npz(path))
    elif path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: the port reads the reference's combined_weights.pth "
            "or a .npz from canonswap_tpu.cli.convert, not .msgpack")
    else:
        sd = W.load_reference_checkpoint(path)
    core.load_state_dict(sd, strict=True)


class FaceSwapSession:
    """Args, as the JAX session's (minus ``rng`` and ``mesh``):
      inference_cfg, crop_cfg: the runtime flags and the crop geometry.
      model_cfg: the generator's widths (CANONICAL; TINY in tests).
      det_size: SCRFD's input (w, h).
      arcface_layers: ArcFace's stage depths.
      parsing_cfg: the Segformer (MiT-B1, 19 labels by default).
      landmark_widths, landmark_trunk: the landmark nets' trunk.
      fast_init: zero weights in place of the seeded ones.
      seed: the components' seeds (:data:`SEED_OFFSETS`).
      device: the card unless the caller asks for the CPU (raises if no
        card is there).  On the card the session turns TF32 off for the
        process, so the f32 sidecars compute in f32.
    """

    def __init__(
        self,
        inference_cfg: InferenceConfig | None = None,
        crop_cfg: CropConfig | None = None,
        model_cfg: CanonSwapModelConfig = CANONICAL,
        det_size: tuple[int, int] = (512, 512),
        arcface_layers: tuple[int, int, int, int] = (3, 4, 23, 3),
        parsing_cfg: P.SegformerConfig | None = None,
        landmark_widths: tuple[int, ...] | None = None,
        landmark_trunk: str = "mobile",
        fast_init: bool = False,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.inference_cfg = inference_cfg or InferenceConfig()
        self.crop_cfg = crop_cfg or CropConfig()
        self.model_cfg = model_cfg = _model_config(self.inference_cfg,
                                                   model_cfg)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        seeds = {k: seed + v for k, v in SEED_OFFSETS.items()}
        dev = self.device

        # generator core: weights made on the CPU, loaded, then cast
        self.core = C.CanonSwapCore(
            model_cfg, seed=None if fast_init else seeds["core"],
            device="cpu")
        if fast_init:
            _zero_(self.core)
        if self.inference_cfg.checkpoint:
            load_core_checkpoint(self.core, self.inference_cfg.checkpoint)
        self.half = bool(self.inference_cfg.flag_use_half_precision)
        self.compute_dtype = torch.bfloat16 if self.half else torch.float32
        self.core.to(dev, self.compute_dtype)

        # perception stack (f32)
        self.lmk106 = Landmark106Runner(
            seed=seeds["landmark106"], trunk=landmark_trunk,
            widths=landmark_widths, device=dev)
        self.face_analysis = FaceAnalysis(
            lmk106=self.lmk106, det_size=det_size,
            det_thresh=self.crop_cfg.det_thresh, seed=seeds["scrfd"],
            device=dev)
        self.landmark203 = Landmark203Runner(
            seed=seeds["landmark203"], trunk=landmark_trunk,
            widths=landmark_widths, device=dev)
        self.cropper = Cropper(self.crop_cfg, self.face_analysis,
                               self.landmark203,
                               network_input_size=model_cfg.input_size,
                               device=dev)
        self.id_cropper = FaceIDCropper(self.face_analysis)
        self.parsing = P.FaceParser(parsing_cfg or P.SegformerConfig(),
                                    seed=seeds["parsing"],
                                    output_size=model_cfg.output_size,
                                    device=dev)
        self.arcface = ArcFaceRunner(layers=arcface_layers,
                                     seed=seeds["arcface"], device=dev)
        if fast_init:
            for net in (self.lmk106.net, self.face_analysis.det_model,
                        self.landmark203.net, self.parsing.model,
                        self.arcface.net):
                _zero_(net)

        # the stitching and retargeting nets (f32), under any of their flags
        cfg = self.inference_cfg
        self.use_stitching = bool(cfg.flag_stitching)
        self.use_eye_retarget = bool(cfg.flag_eye_retargeting)
        self.use_lip_retarget = bool(cfg.flag_lip_retargeting)
        self.stitching = None
        if self.use_stitching or self.use_eye_retarget \
                or self.use_lip_retarget:
            self.stitching = StitchingModule(model_cfg.motion.num_kp,
                                             model_cfg.stitching)
            if fast_init:
                _zero_(self.stitching)
            else:
                init_random_(self.stitching, seeds["stitching"])
            self.stitching.eval().requires_grad_(False).to(dev)
            if cfg.stitching_checkpoint:
                self.load_stitching_checkpoint(cfg.stitching_checkpoint)

    def load_stitching_checkpoint(self, path: str) -> None:
        """The reference's stitching checkpoint (``.pth``) or its ``.npz``
        from ``canonswap_tpu.cli.convert stitching``, strict keys
        (``runtime/weights.py::load_stitching_checkpoint``)."""
        from canonswap_torch.runtime.weights import load_stitching_checkpoint

        self.stitching.load_state_dict(load_stitching_checkpoint(path),
                                       strict=True)

    def synchronize(self) -> None:
        """Wait for the session's device (a no-op on the CPU): a stage timed
        on the host clock ends here."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def get_source_id(self, source_rgb) -> torch.Tensor:
        """Source image -> (1, latent) L2-normalized ID embedding on the
        device (can_swap_pipeline_e2e.py:90-99); raises if no face."""
        return source_id(self.id_cropper, self.arcface, source_rgb,
                         self.model_cfg.swap.latent_dim)

    def parse_masks(self, crops) -> torch.Tensor:
        """(B, S, S, 3) uint8 crops -> (B, 2S, 2S, 1) feathered swap masks
        in [0, 1] on the device (can_swap_pipeline_e2e.py:177-191, 275)."""
        return self.parsing.parse_masks(on_device(crops, self.device))

    def parse_masks_uint8(self, crops) -> torch.Tensor:
        """:meth:`parse_masks` quantized on the device to 0..255 uint8."""
        return C.to_uint8(self.parse_masks(crops))

    def motion_template(self, frames01: torch.Tensor) -> dict:
        """The motion dict (f32) of prepared frames (B, S, S, 3)."""
        with torch.inference_mode():
            return C.extract_motion(self.core, frames01)

    def _adjust(self, eye_ratio, lip_ratio) -> dict:
        """The keypoint adjustment's arguments under the session's flags;
        the ratios ((B, 3) eye, (B, 2) lip; numpy or tensors) go to the
        device in f32, each only under its flag."""
        def ratio(r, on):
            return (torch.as_tensor(r).to(self.device, torch.float32)
                    if on and r is not None else None)

        return dict(stitching=self.stitching,
                    eye_ratio=ratio(eye_ratio, self.use_eye_retarget),
                    lip_ratio=ratio(lip_ratio, self.use_lip_retarget),
                    use_stitching=self.use_stitching,
                    normalize_lip=bool(self.inference_cfg.flag_normalize_lip))

    def swap_with_motion(self, frames01: torch.Tensor,
                         source_id: torch.Tensor, with_debug: bool = False,
                         as_uint8: bool = False, eye_ratio=None,
                         lip_ratio=None) -> tuple[dict, dict]:
        """Motion extraction and the swap of one batch; images in f32, or
        uint8 quantized on the device under ``as_uint8``.  The keypoints
        are adjusted under the stitching flags; the motion returned is the
        unadjusted one (``runtime/core.py::swap_with_motion``)."""
        out, motion = C.swap_with_motion(
            self.core, frames01, source_id, with_debug=with_debug,
            as_uint8=as_uint8, **self._adjust(eye_ratio, lip_ratio))
        if not as_uint8:
            out = {k: v.float() for k, v in out.items()}
        return out, motion

    def swap_batch(self, frames01: torch.Tensor, source_id: torch.Tensor,
                   motion: dict, with_debug: bool = False, eye_ratio=None,
                   lip_ratio=None) -> dict:
        """The swap of one batch at a given motion (the cached-template
        path): the motion arrays go to the device in f32, and x_t is
        adjusted under the stitching flags, as the fused path adjusts it."""
        motion = {k: torch.as_tensor(v).to(self.device, torch.float32)
                  for k, v in motion.items()}
        with torch.inference_mode():
            if self.stitching is not None:
                motion["x_t"] = C.adjust_driving_kp(
                    x_t=motion["x_t"], **self._adjust(eye_ratio, lip_ratio))
            out = C.swap_step(self.core, frames01, source_id, motion,
                              with_debug=with_debug)
        return {k: v.float() for k, v in out.items()}

    def prepare_frames(self, frames_uint8) -> torch.Tensor:
        """uint8 (B, S, S, 3) (numpy, or a tensor left where it is) ->
        [0, 1] frames in the compute dtype on the device: divided by 255 in
        f32, then cast, as the JAX session computes them."""
        x = on_device(frames_uint8, self.device)
        return (x.float() / 255.0).to(self.compute_dtype)
