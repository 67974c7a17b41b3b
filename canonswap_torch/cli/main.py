"""The port's command line, the counterpart of ``canonswap_tpu/cli/main.py``
(the reference's two scripts, plus this framework's two pipelines):

    python -m canonswap_torch.cli.main swap   -s SRC -t DRV -o OUT
    python -m canonswap_torch.cli.main v2i    -s SRC -t DRV -o OUT
    python -m canonswap_torch.cli.main multi  -s SRC -t DRV -o OUT
    python -m canonswap_torch.cli.main stream -s SRC -t DRV -o OUT

``swap`` is inference_canswap.py (video face swap), ``v2i``
inference_v2i.py (a clip's motion drives the swapped source image),
``multi`` every face of the clip (pipelines/swap_multi.py), ``stream`` the
threaded decode / device / encode pipeline (pipelines/streaming.py).  The
flags are ``ArgumentConfig``'s fields with the reference's -s/-t/-o aliases
(inference_canswap.py:36, argument_config.py:16-18).  The session runs on
the card; ``.ppm`` images and ``.npy`` clips need no codec.
"""

from __future__ import annotations

import argparse
import dataclasses
import os.path as osp
import sys

from canonswap_torch.configs import (ArgumentConfig, CropConfig,
                                     InferenceConfig, partial_fields)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="canonswap-torch")
    sub = p.add_subparsers(dest="mode", required=True)
    for mode in ("swap", "v2i", "multi", "stream"):
        sp = sub.add_parser(mode)
        sp.add_argument("-s", "--source", required=True,
                        help="source portrait (identity)")
        sp.add_argument("-t", "--driving", required=True,
                        help="target/driving video or image")
        sp.add_argument("-o", "--output-dir", default="results/")
        for f in dataclasses.fields(ArgumentConfig):
            if f.name in ("source", "driving", "output_dir"):
                continue
            arg = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                sp.add_argument(
                    arg, type=lambda v: v.lower() in ("1", "true", "yes"),
                    default=f.default)
            elif f.default is None:
                sp.add_argument(arg, default=None)
            else:
                sp.add_argument(arg, type=type(f.default), default=f.default)
    return p


def fast_check_args(args: ArgumentConfig):
    if not osp.exists(args.source):
        raise FileNotFoundError(f"source info not found: {args.source}")
    if not osp.exists(args.driving):
        raise FileNotFoundError(f"driving info not found: {args.driving}")


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), build the session on the
    card and run the mode's pipeline; returns what the pipeline returns."""
    ns = build_parser().parse_args(argv)
    kwargs = {k: v for k, v in vars(ns).items() if k != "mode"}
    args = ArgumentConfig(**kwargs)
    fast_check_args(args)

    inference_cfg = partial_fields(InferenceConfig, dataclasses.asdict(args))
    crop_cfg = partial_fields(CropConfig, dataclasses.asdict(args))
    # entry-point overrides matching the reference (inference_canswap.py:56-58)
    inference_cfg.flag_crop_driving_video = args.flag_crop_driving_video

    from canonswap_torch.pipelines.session import FaceSwapSession

    session = FaceSwapSession(inference_cfg, crop_cfg,
                              fast_init=args.fast_init)
    if ns.mode == "swap":
        from canonswap_torch.pipelines import swap_e2e

        return swap_e2e.execute(session, args)
    if ns.mode == "v2i":
        from canonswap_torch.pipelines import swap_v2i

        return swap_v2i.execute(session, args)
    if ns.mode == "multi":
        from canonswap_torch.pipelines import swap_multi

        return swap_multi.execute(session, args)
    from canonswap_torch.pipelines import streaming

    return streaming.execute(session, args)


if __name__ == "__main__":
    main(sys.argv[1:])
