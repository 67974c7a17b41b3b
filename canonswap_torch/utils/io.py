"""Image and motion-template I/O on the host.

The port's counterpart of ``canonswap_tpu/utils/io.py`` (the reference's
src/utils/io.py:12-117).  Two formats need no codec and are read and
written with numpy alone, bit for bit: binary PPM (``P6``, 8-bit RGB) for
images, and ``.npy`` frame stacks (N, H, W, 3) uint8 RGB for video
(``utils/video.py``).  PNG, JPEG and the other image formats go through
cv2, imported where it is used; without cv2 they raise an ImportError that
names the file.  Motion templates are pickles of numpy arrays and Python
scalars, the JAX package's format, so a template dumped by either package
loads in the other.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")
VIDEO_EXTS = (".mp4", ".mov", ".avi", ".webm", ".mkv", ".npy")


def import_cv2(path: str):
    """cv2, for a file whose format needs a codec; raises an ImportError
    naming ``path`` where cv2 is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path}: this format needs cv2 (OpenCV), which is not "
            "installed; use .ppm for images and .npy (N, H, W, 3) uint8 RGB "
            "frame stacks for video") from e
    return cv2


def _ppm_tokens(f, n: int) -> list[bytes]:
    """The next ``n`` whitespace-separated header tokens, '#' comments
    skipped; the single whitespace byte after the last is consumed."""
    tokens, tok = [], b""
    while len(tokens) < n:
        c = f.read(1)
        if not c:
            raise ValueError("truncated PPM header")
        if c == b"#" and not tok:
            f.readline()
        elif c.isspace():
            if tok:
                tokens.append(tok)
                tok = b""
        else:
            tok += c
    return tokens


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (P6, maxval 255) -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        magic, w, h, maxval = _ppm_tokens(f, 4)
        if magic != b"P6" or int(maxval) != 255:
            raise ValueError(f"{path}: not an 8-bit binary PPM (P6, maxval "
                             f"255): {magic!r}, maxval {int(maxval)}")
        w, h = int(w), int(h)
        data = f.read(w * h * 3)
    if len(data) != w * h * 3:
        raise ValueError(f"{path}: truncated PPM ({len(data)} of "
                         f"{w * h * 3} bytes)")
    return np.frombuffer(data, np.uint8).reshape(h, w, 3).copy()


def write_ppm(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: PPM takes (H, W, 3) RGB, got {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def load_image_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    if not osp.exists(path):
        raise FileNotFoundError(f"Image not found: {path}")
    if path.lower().endswith(".ppm"):
        return read_ppm(path)
    cv2 = import_cv2(path)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"Failed to decode image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def save_image_rgb(path: str, img: np.ndarray) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    if path.lower().endswith(".ppm"):
        write_ppm(path, img)
        return
    cv2 = import_cv2(path)
    if not cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR)):
        raise ValueError(f"Failed to encode image: {path}")


def resize_to_limit(img: np.ndarray, max_dim: int = 1920, division: int = 2):
    """Cap the longer side at ``max_dim`` and crop each side to a multiple
    of ``division`` (io.py:37-60); the resize is ``cv2.resize``'s bilinear
    (``ops/resize.py::resize_like_cv2``, within one grey level of cv2)."""
    h, w = img.shape[:2]
    if max_dim > 0 and max(h, w) > max_dim:
        import torch

        from canonswap_torch.ops.resize import resize_like_cv2

        if h > w:
            new_h, new_w = max_dim, int(w * (max_dim / h))
        else:
            new_h, new_w = int(h * (max_dim / w)), max_dim
        img = resize_like_cv2(torch.from_numpy(np.ascontiguousarray(img)),
                              (new_h, new_w)).numpy()
    division = max(division, 1)
    nh = img.shape[0] - (img.shape[0] % division)
    nw = img.shape[1] - (img.shape[1] % division)
    if 0 < nh != img.shape[0] or 0 < nw != img.shape[1]:
        img = img[:nh, :nw]
    return img


def dump(path: str, obj) -> None:
    """Pickle/numpy template dump (the motion-template cache)."""
    wd = osp.split(path)[0]
    if wd:
        os.makedirs(wd, exist_ok=True)
    if path.endswith((".pkl", ".pickle")):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    elif path.endswith(".npy"):
        np.save(path, obj)
    else:
        raise ValueError(f"Unknown template format: {path}")


def load(path: str):
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            return pickle.load(f)
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True)
    raise ValueError(f"Unknown template format: {path}")


def is_image(path: str) -> bool:
    return path.lower().endswith(IMAGE_EXTS)


def is_video(path: str) -> bool:
    return path.lower().endswith(VIDEO_EXTS) or osp.isdir(path)


def is_template(path: str) -> bool:
    return path.endswith(".pkl")


def basename(path: str) -> str:
    return osp.splitext(osp.basename(path))[0]
