"""The port's weights: the round trip through the JAX package's converters,
the seeded init, and a port that imports without JAX."""

from __future__ import annotations

import ast
import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.configs import TINY
from canonswap_torch.models import landmark as PL
from canonswap_torch.models import parsing as PP
from canonswap_torch.nn.init import init_random_
from canonswap_torch.runtime import core as C
from canonswap_torch.runtime.weights import (
    FROM_JAX, from_jax, landmark_from_jax, load_reference_checkpoint,
    segformer_from_jax)
from canonswap_tpu.models import landmark as JL
from canonswap_tpu.models import parsing as JP
from canonswap_tpu.runtime import weights as JW
from tests.helpers.torch_parity import np_state_dict, randomized

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def core():
    return C.CanonSwapCore(TINY, seed=0, device="cpu")


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
    fresh = C.CanonSwapCore(TINY, seed=None, device="cpu")
    fresh.load_state_dict(from_jax(variables), strict=True)
    for k, v in core.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def _reference_shaped_checkpoint(core) -> dict:
    """The port core's weights in the reference's combined_weights.pth
    layout: SPADE resblock convs spectral-normalized (stored weight_orig,
    u, v), a DistributedDataParallel ``module.`` prefix on one network and a
    ``torch.compile`` ``_orig_mod.`` prefix on another, and the decoder's
    conv_img bare."""
    torch.manual_seed(11)
    spade = copy.deepcopy(core.spade_generator)
    for name in [f"G_middle_{i}" for i in range(6)] + ["up_0", "up_1"]:
        block = getattr(spade, name)
        for conv in ("conv_0", "conv_1", "conv_s"):
            if hasattr(block, conv):
                torch.nn.utils.spectral_norm(getattr(block, conv))
    spade.train()
    with torch.no_grad():  # one power iteration: u, v as training leaves them
        spade(torch.randn((1, spade.fc.in_channels, 8, 8)))
    spade.eval()
    ckpt = {net: getattr(core, net).state_dict() for net in FROM_JAX}
    ckpt["spade_generator"] = {
        k.replace("conv_img.0.", "conv_img."): v
        for k, v in spade.state_dict().items()}
    assert any(k.endswith(".weight_orig") for k in ckpt["spade_generator"])
    ckpt["motion_extractor"] = {f"module.{k}": v for k, v in
                                ckpt["motion_extractor"].items()}
    ckpt["warping_module"] = {f"_orig_mod.{k}": v for k, v in
                              ckpt["warping_module"].items()}
    return ckpt


def test_reference_checkpoint_loads_without_jax(core, tmp_path):
    """A reference-shaped combined checkpoint loads strictly through the
    port's own loader, and each tensor equals the JAX package's converter
    followed by from_jax within rtol 1e-6 (the bake's one division, its
    sigma summed in another order)."""
    ckpt = _reference_shaped_checkpoint(core)
    path = tmp_path / "combined_weights.pth"
    torch.save(ckpt, path)
    sd = load_reference_checkpoint(path)
    fresh = C.CanonSwapCore(TINY, seed=None, device="cpu")
    fresh.load_state_dict(sd, strict=True)
    want = from_jax(JW.convert_combined_checkpoint(
        {net: {k: v.numpy() for k, v in part.items()}
         for net, part in ckpt.items()}))
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=1e-6, atol=0, msg=k)
    # the baked weights are the spectral-normalized ones, not the originals
    key = "spade_generator.G_middle_0.conv_0.weight"
    assert not torch.allclose(sd[key], core.state_dict()[key])
    # the dict itself loads the same
    same = load_reference_checkpoint(ckpt)
    assert all(torch.equal(same[k], sd[k]) for k in sd)


def test_reference_checkpoint_missing_a_network_raises(core):
    ckpt = {net: getattr(core, net).state_dict() for net in FROM_JAX}
    del ckpt["refine"]
    with pytest.raises(KeyError, match="refine"):
        load_reference_checkpoint(ckpt)


def _imported(node) -> list[str]:
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        return [node.module or ""]
    return []


def _module_level(body):
    """The statements that run when the module is imported: the top level,
    with the bodies of top-level if / try / with blocks."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody"):
                yield from _module_level(getattr(node, field, []))
            for handler in getattr(node, "handlers", []):
                yield from _module_level(handler.body)


def test_port_sources_import_nothing_of_jax():
    """A source scan of every module of the port, the checkpoint loader's
    included: no import of jax, flax or the JAX package anywhere; and no
    import of cv2, PIL or rich when a module is imported (the card's
    machine has none of them: the port imports cv2 where a codec format
    needs it, rich where it logs)."""
    banned = ("jax", "flax", "canonswap_tpu")
    not_at_import = ("cv2", "PIL", "rich")
    files = sorted((REPO / "canonswap_torch").rglob("*.py"))
    for name in ("runtime/weights.py", "runtime/face_analysis.py",
                 "runtime/cropper.py", "models/scrfd.py", "models/arcface.py",
                 "ops/detection.py", "utils/face_align.py",
                 "utils/smoothing.py", "utils/io.py", "utils/video.py",
                 "utils/ratios.py", "utils/rlog.py", "utils/timing.py",
                 "utils/helper.py", "pipelines/session.py",
                 "pipelines/swap_e2e.py", "pipelines/swap_v2i.py",
                 "pipelines/swap_multi.py", "pipelines/streaming.py",
                 "cli/main.py"):
        assert REPO / "canonswap_torch" / name in files
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            for name in _imported(node):
                assert name.split(".")[0] not in banned, (path, name)
        for node in _module_level(tree.body):
            for name in _imported(node):
                assert name.split(".")[0] not in not_at_import, (path, name)


def test_seeded_init(core):
    same = C.CanonSwapCore(TINY, seed=0, device="cpu").state_dict()
    other = C.CanonSwapCore(TINY, seed=1, device="cpu").state_dict()
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
        "from canonswap_torch import configs\n"
        "from canonswap_torch.configs import TINY\n"
        "from canonswap_torch.ops.cuda import ms_deform_attn\n"
        "from canonswap_torch.models.xpose import runner, unipose\n"
        "from canonswap_torch.models import landmark, parsing\n"
        "from canonswap_torch.ops.cuda import probes\n"
        "from canonswap_torch.tools import launch_cost, profile_r2\n"
        "from canonswap_torch.ops.cuda import qconv\n"
        "from canonswap_torch.models import arcface, scrfd\n"
        "from canonswap_torch.ops import detection\n"
        "from canonswap_torch.runtime import cropper, face_analysis\n"
        "from canonswap_torch.utils import face_align, smoothing\n"
        "landmark.Landmark203Runner(device='cpu')\n"
        "fa = face_analysis.FaceAnalysis(\n"
        "    lmk106=landmark.Landmark106Runner(device='cpu'), device='cpu')\n"
        "arcface.ArcFaceRunner(layers=(1, 1, 1, 1), device='cpu')\n"
        "cropper.Cropper(configs.CropConfig(), fa,\n"
        "                landmark.Landmark203Runner(device='cpu'),\n"
        "                device='cpu')\n"
        "core.CanonSwapCore(TINY, device='cpu')\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_core_without_a_device_needs_a_card(monkeypatch):
    """The entry point runs on the card unless the caller asks for the CPU:
    with no card, ``CanonSwapCore(TINY)`` raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.CanonSwapCore(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.CanonSwapCore(TINY, device="cuda:0")


def test_segformer_round_trip_through_convert():
    """port (HF-keyed) state_dict -> convert_hf_segformer -> from_jax gives
    it back exactly."""
    model = init_random_(PP.Segformer(PP.TINY), 0)
    sd = model.state_dict()
    cfg = JP.SegformerConfig(**{f: getattr(PP.TINY, f)
                                for f in PP.TINY.__dataclass_fields__})
    back = segformer_from_jax(JP.convert_hf_segformer(np_state_dict(model),
                                                      cfg))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def _landmark_to_jax(sd: dict) -> dict:
    """The port's MobileLandmarkNet state_dict -> the JAX tree, with the
    JAX package's torch-layout readers (a depthwise conv's kernel takes the
    same transpose as any conv's)."""
    sd = {k: v.numpy() for k, v in sd.items()}
    params = {}
    for key in {k.rsplit(".", 1)[0] for k in sd}:
        node = params
        for part in key.split(".")[:-1]:
            node = node.setdefault(part, {})
        name, w = key.split(".")[-1], sd.get(f"{key}.weight")
        if key.endswith("_act"):
            node[name] = {"alpha": sd[f"{key}.alpha"]}
        elif w.ndim == 2:
            node[name] = JW._dense(sd, key)
        else:
            node[name] = JW._conv(sd, key)
    return {"params": params}


def test_landmark_round_trip():
    """JAX variables -> landmark_from_jax -> the port net, strictly -> the
    same JAX tree back, leaf for leaf; the port net's own keys likewise."""
    net = JL.MobileLandmarkNet(num_points=203)
    v = randomized(jax.jit(net.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 224, 224, 3))), seed=2)
    port = PL.MobileLandmarkNet(203)
    port.load_state_dict(landmark_from_jax(v), strict=True)
    back = _landmark_to_jax(port.state_dict())
    flat = jax.tree_util.tree_flatten_with_path
    want, got = flat(v)[0], flat(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert np.asarray(a).dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    seeded = init_random_(PL.MobileLandmarkNet(203), 0).state_dict()
    again = landmark_from_jax(_landmark_to_jax(seeded))
    assert sorted(again) == sorted(seeded)
    assert all(torch.equal(again[k], seeded[k]) for k in seeded)
