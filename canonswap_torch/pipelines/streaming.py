"""Streaming video swap: decode and tracking, the device swap, and the
paste-back and encode overlap on three threads.

The port's counterpart of ``canonswap_tpu/pipelines/streaming.py``: over
fixed-shape frame batches (``utils/video.py::BatchedVideoReader``),

  [producer thread]  upload, landmark tracking, crop    (on the device)
  [main thread]      motion, swap, parsing              (on the device)
  [consumer thread]  paste-back, copy to the host, encode

with queues of two batches between them, so the host's decode, tracking
launches and encode hide under the generator.  Until the first face is
found, a frame gets a zero crop at the identity transform, as in the JAX
package.  An exception in any thread stops the stream and is raised to
the caller.
"""

from __future__ import annotations

import os
import os.path as osp
import queue
import threading

import numpy as np
import torch

from canonswap_torch.configs import ArgumentConfig
from canonswap_torch.ops.resize import area_resize_like_cv2
from canonswap_torch.pipelines.session import FaceSwapSession
from canonswap_torch.pipelines.swap_e2e import video_ext
from canonswap_torch.utils import geometry as G
from canonswap_torch.utils import io as IO
from canonswap_torch.utils import video as V
from canonswap_torch.utils.rlog import log
from canonswap_torch.utils.timing import StageTimer


def _drain(q: queue.Queue) -> None:
    """Take items until the end marker, so the thread feeding ``q`` ends."""
    while q.get() is not None:
        pass


def execute(session: FaceSwapSession, args: ArgumentConfig,
            timer: StageTimer | None = None):
    """Returns the result's path.  ``timer`` collects the three stages'
    host-clock times (the device stage ends in a synchronize; the producer's
    ends when its landmarks are on the host, its crops still queued)."""
    inf_cfg = session.inference_cfg
    batch = inf_cfg.batch_size
    dev = session.device
    cfg = session.crop_cfg
    nis = session.cropper.network_input_size
    timer = timer or StageTimer()

    source_rgb = IO.load_image_rgb(args.source)
    source_id = session.get_source_id(source_rgb)

    os.makedirs(args.output_dir, exist_ok=True)
    stem = f"{IO.basename(args.source)}--{IO.basename(args.driving)}_stream"
    wfp = osp.join(args.output_dir, f"{stem}{video_ext(args.driving)}")

    reader = V.BatchedVideoReader(args.driving, batch)
    writer = V.VideoWriterRGB(wfp, reader.fps, inf_cfg.crf)

    in_q: queue.Queue = queue.Queue(maxsize=2)
    out_q: queue.Queue = queue.Queue(maxsize=2)
    errors: list[BaseException] = []
    stop = threading.Event()

    def producer():
        try:
            lmk = None
            for frames_np, valid in reader:
                if stop.is_set():
                    return
                crops, m_c2o = [], []
                # no synchronize here: it would wait for the generator's
                # work on the shared stream and stall the overlap
                with timer.stage("host/track+crop", items=valid):
                    frames = torch.from_numpy(frames_np).to(dev)
                    for f in frames:
                        if lmk is None:
                            l106 = session.cropper._detect_lmk(f)
                            if l106 is None:
                                crops.append(torch.zeros(
                                    (nis, nis, 3), dtype=torch.uint8,
                                    device=dev))
                                m_c2o.append(np.eye(3, dtype=np.float32))
                                continue
                            lmk = session.landmark203.run(f, l106)
                        else:
                            lmk = session.landmark203.run(f, lmk)
                        ret = G.crop_image(
                            f, lmk, dsize=cfg.dsize, scale=cfg.scale,
                            vy_ratio=cfg.vy_ratio,
                            flag_do_rot=cfg.flag_do_rot)
                        crops.append(area_resize_like_cv2(ret["img_crop"],
                                                          (nis, nis)))
                        m_c2o.append(ret["M_c2o"])
                in_q.put((frames, torch.stack(crops), m_c2o, valid))
        except BaseException as e:  # raised again by the main thread
            errors.append(e)
        finally:
            in_q.put(None)

    def consumer():
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                frames, res, masks, m_c2o, valid = item
                with timer.stage("host/pasteback+encode", items=valid):
                    h, w = frames.shape[1:3]
                    pasted = torch.stack([
                        G.paste_back(res[j], m_c2o[j], frames[j],
                                     G.prepare_paste_back(
                                         masks[j], m_c2o[j], (w, h),
                                         if_float=True))
                        for j in range(valid)]).cpu().numpy()
                    for frame in pasted:
                        writer.write(frame)
        except BaseException as e:  # raised again by the main thread
            errors.append(e)
            _drain(out_q)

    tp = threading.Thread(target=producer, daemon=True)
    tc = threading.Thread(target=consumer, daemon=True)
    tp.start()
    tc.start()

    n_done = 0
    try:
        while True:
            item = in_q.get()
            if item is None:
                break
            frames, crops, m_c2o, valid = item
            with timer.stage("device/swap", items=valid,
                             sync=session.synchronize):
                frames01 = session.prepare_frames(crops)
                out, _ = session.swap_with_motion(frames01, source_id,
                                                  as_uint8=True)
                masks = session.parse_masks_uint8(crops).float() / 255.0
            out_q.put((frames, out["out"], masks, m_c2o, valid))
            n_done += valid
            if n_done % (batch * 8) == 0:
                log(f"streamed {n_done} frames")
    except BaseException:
        stop.set()
        _drain(in_q)
        raise
    finally:
        out_q.put(None)
        tc.join()
        tp.join()
        writer.close()
    if errors:
        raise errors[0]
    if V.has_audio_stream(args.driving):
        tmp = wfp + ".audio.mp4"
        if V.add_audio_to_video(wfp, args.driving, tmp):
            os.replace(tmp, wfp)
    log(f"Results: {wfp} ({n_done} frames)")
    log(timer.report())
    return wfp
