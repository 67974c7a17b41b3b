"""Video decode and encode, with a batched reader that prefetches on a
thread.

The port's counterpart of ``canonswap_tpu/utils/video.py`` (the reference's
src/utils/video.py).  A ``.npy`` clip, an (N, H, W, 3) uint8 RGB frame
stack, needs no codec: it is read with numpy and written incrementally,
its header written when the writer closes.  The video containers (.mp4 and
the rest of ``utils/io.py::VIDEO_EXTS``) are read through cv2 and written
through ``ffmpeg`` (libx264 at ``crf``) where ``shutil.which`` finds it,
else through cv2 (mp4v); without them they raise an ImportError that names
the file.  Audio is muxed by ``ffmpeg`` only, as in the JAX package.
"""

from __future__ import annotations

import os
import os.path as osp
import queue
import shutil
import struct
import subprocess
import threading
from collections.abc import Iterator

import numpy as np

from canonswap_torch.utils.io import import_cv2


def is_npy(path: str) -> bool:
    return path.lower().endswith(".npy")


def _open_npy(path: str) -> np.ndarray:
    """A ``.npy`` clip, memory-mapped; raises if it is not (N, H, W, 3)
    uint8."""
    if not osp.exists(path):
        raise FileNotFoundError(f"Cannot open video: {path}")
    arr = np.load(path, mmap_mode="r")
    if arr.dtype != np.uint8 or arr.ndim != 4 or arr.shape[3] != 3:
        raise ValueError(f"{path}: a .npy clip is an (N, H, W, 3) uint8 RGB "
                         f"frame stack, got {arr.dtype} {arr.shape}")
    return arr


def get_fps(path: str, default_fps: float = 25.0) -> float:
    """The container's frame rate; ``default_fps`` for a ``.npy`` clip,
    which has none, and where cv2 gives no answer."""
    if is_npy(path):
        return default_fps
    cv2 = import_cv2(path)
    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
    finally:
        cap.release()
    return fps if fps else default_fps


def frame_size(path: str) -> tuple[int, int]:
    """(width, height) of a clip's frames."""
    if is_npy(path):
        _, h, w, _ = _open_npy(path).shape
        return w, h
    cv2 = import_cv2(path)
    cap = cv2.VideoCapture(path)
    try:
        return (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    finally:
        cap.release()


def iter_video(path: str) -> Iterator[np.ndarray]:
    """The clip's frames, (H, W, 3) uint8 RGB, one at a time."""
    if is_npy(path):
        for frame in _open_npy(path):
            yield np.array(frame)
        return
    cv2 = import_cv2(path)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video: {path}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def load_video(path: str, n_frames: int = -1) -> list[np.ndarray]:
    """Decode a clip to a list of RGB frames (the reference's io.py:19-29)."""
    if is_npy(path):
        arr = _open_npy(path)
        return list(np.array(arr if n_frames < 0 else arr[:n_frames]))
    frames = []
    for frame in iter_video(path):
        if 0 <= n_frames <= len(frames):
            break
        frames.append(frame)
    return frames


class _ReaderError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchedVideoReader:
    """Streams (batch, H, W, 3) frame stacks decoded on a background thread.

    The last batch is padded by repeating its last frame, so every batch
    has one shape; ``valid`` is the true count.  An exception raised while
    decoding is raised again to the consumer, in place of the end of the
    stream."""

    def __init__(self, path: str, batch_size: int, prefetch: int = 2):
        self.batch_size = batch_size
        self.fps = get_fps(path)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(
            target=self._worker, args=(path,), daemon=True)
        self._thread.start()

    def _worker(self, path):
        buf = []
        try:
            for frame in iter_video(path):
                buf.append(frame)
                if len(buf) == self.batch_size:
                    self._q.put((np.stack(buf), self.batch_size))
                    buf = []
            if buf:
                valid = len(buf)
                while len(buf) < self.batch_size:
                    buf.append(buf[-1])
                self._q.put((np.stack(buf), valid))
        except BaseException as e:  # raised again in the consumer
            self._q.put(_ReaderError(e))
        finally:
            self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, _ReaderError):
                raise item.exc
            yield item  # (frames (B, H, W, 3) uint8 RGB, valid count)


_NPY_HEADER_BYTES = 128


def _npy_header(shape: tuple[int, ...]) -> bytes:
    """A format-1.0 ``.npy`` header of a uint8 C-order array, padded to
    ``_NPY_HEADER_BYTES`` so it can be written again over its first form."""
    body = repr({"descr": "|u1", "fortran_order": False,
                 "shape": tuple(shape)}).encode("latin1")
    pad = _NPY_HEADER_BYTES - 10 - len(body) - 1
    if pad < 0:
        raise ValueError(f"shape {shape} does not fit the .npy header")
    return (b"\x93NUMPY\x01\x00" + struct.pack("<H", _NPY_HEADER_BYTES - 10)
            + body + b" " * pad + b"\n")


class VideoWriterRGB:
    """Incremental clip writer, RGB frames in.  ``.npy``: raw frames after
    a header written again with the frame count on ``close``; a video
    container: libx264 at ``crf`` through ``ffmpeg`` where it is found,
    else cv2's mp4v; without either, the constructor raises."""

    def __init__(self, path: str, fps: float, crf: int = 18):
        self.path = path
        self.fps = fps
        self.crf = crf
        self.n_frames = 0
        self._shape = None
        self._file = None  # .npy
        self._proc = None  # ffmpeg
        self._writer = None  # cv2
        self._ffmpeg = None if is_npy(path) else shutil.which("ffmpeg")
        self._cv2 = None
        if not is_npy(path) and self._ffmpeg is None:
            self._cv2 = import_cv2(path)

    def _open(self, h, w):
        os.makedirs(osp.dirname(osp.abspath(self.path)), exist_ok=True)
        if is_npy(self.path):
            self._file = open(self.path, "wb")
            self._file.write(_npy_header((0, h, w, 3)))
        elif self._ffmpeg:
            cmd = [
                self._ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                "-s", f"{w}x{h}", "-r", str(self.fps), "-i", "-",
                "-c:v", "libx264", "-crf", str(self.crf),
                "-pix_fmt", "yuv420p", self.path,
            ]
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
        else:
            cv2 = self._cv2
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
            if not self._writer.isOpened():
                raise OSError(f"cv2 cannot open a video writer for "
                              f"{self.path}")

    def write(self, frame_rgb: np.ndarray):
        frame = np.ascontiguousarray(frame_rgb, dtype=np.uint8)
        if self._shape is None:
            self._shape = frame.shape
            self._open(*frame.shape[:2])
        elif frame.shape != self._shape:
            raise ValueError(f"{self.path}: frame {frame.shape} after frames "
                             f"of {self._shape}")
        if self._file is not None:
            self._file.write(frame.tobytes())
        elif self._proc is not None:
            self._proc.stdin.write(frame.tobytes())
        else:
            self._writer.write(self._cv2.cvtColor(frame,
                                                  self._cv2.COLOR_RGB2BGR))
        self.n_frames += 1

    def close(self):
        if self._file is not None:
            self._file.seek(0)
            self._file.write(_npy_header((self.n_frames, *self._shape)))
            self._file.close()
            self._file = None
        if self._proc is not None:
            self._proc.stdin.close()
            rc = self._proc.wait()
            self._proc = None
            if rc:
                raise OSError(f"ffmpeg exited with {rc} writing {self.path}")
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def images2video(images, wfp: str, fps: float = 25.0, crf: int = 18):
    with VideoWriterRGB(wfp, fps, crf) as w:
        for img in images:
            w.write(img)


def concat_frames(*frame_lists) -> list[np.ndarray]:
    """Per-frame debug strips side by side, each stream resized to the
    first stream's height (the reference's video.py:84-109) by
    ``resize_like_cv2``."""
    import torch

    from canonswap_torch.ops.resize import resize_like_cv2

    n = min(len(lst) for lst in frame_lists)
    out = []
    for i in range(n):
        ref_h = frame_lists[0][i].shape[0]
        row = []
        for lst in frame_lists:
            f = lst[i]
            if f.shape[0] != ref_h:
                scale = ref_h / f.shape[0]
                f = resize_like_cv2(torch.from_numpy(np.ascontiguousarray(f)),
                                    (ref_h, int(f.shape[1] * scale))).numpy()
            row.append(f)
        out.append(np.concatenate(row, axis=1))
    return out


def has_audio_stream(path: str) -> bool:
    """Whether ``ffprobe`` finds an audio stream; False without it, and for
    a ``.npy`` clip or a directory."""
    ffprobe = shutil.which("ffprobe")
    if not ffprobe or osp.isdir(path) or is_npy(path):
        return False
    r = subprocess.run(
        [ffprobe, "-v", "error", "-select_streams", "a",
         "-show_entries", "stream=codec_type",
         "-of", "default=noprint_wrappers=1:nokey=1", path],
        capture_output=True, text=True)
    return r.returncode == 0 and bool(r.stdout.strip())


def add_audio_to_video(silent: str, audio_src: str, out: str) -> bool:
    """Mux ``audio_src``'s audio into ``silent``'s video as ``out`` with
    ``ffmpeg``; False without it or where it fails, as in the JAX
    package."""
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        return False
    r = subprocess.run(
        [ffmpeg, "-y", "-i", silent, "-i", audio_src, "-map", "0:v",
         "-map", "1:a", "-c:v", "copy", "-shortest", out],
        capture_output=True)
    return r.returncode == 0
