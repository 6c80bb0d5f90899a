"""Command-line interface: parity with the reference's CLI + HCI keys (own
copy of the JAX package's cli.py).

Reference: git-style subcommands `video` (--RECALIBRATE, --RECAPTURE) and
`image` (-l/-r/-g), required global -a/--alg {STEREO_GIF, STEREO_SGBM}
(parse_cli, src/StereoMatch.cpp:662-752). The interactive keyboard toggles
(src/main.cpp:96-195) become flags: --dataset ('d'), --mask ('o'),
--subsample ('s'), --threshold (trackbar), --timed (monitors). --device
picks the engines' device: the CUDA card unless 'cpu' is given. --trace DIR
runs the frames under torch.profiler and writes DIR/trace.json, a Chrome
trace of the device's kernels beside the program's `psm.*` spans.

Headless: mosaics are written as PNGs with --out instead of imshow.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys

from primestereomatch_torch.app import AppConfig, StereoMatchApp
from primestereomatch_torch.utils.datasets import DATASETS
from primestereomatch_torch.utils.profiling import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="psm-torch",
        description="Stereo matching for depth estimation (PyTorch/CUDA).",
    )
    p.add_argument(
        "-a", "--alg", required=True, choices=["STEREO_GIF", "STEREO_SGBM"],
        help="The stereo matching algorithm to use.",
    )
    p.add_argument("--max-dis", type=int, default=64)
    p.add_argument("--subsample", type=int, default=4, choices=[1, 2, 4, 8],
                   help="FGF subsample rate ('s' key in the reference)")
    p.add_argument("--med-sz", type=int, default=19)
    p.add_argument("--threshold", type=int, default=4,
                   help="bad-pixel error threshold (reference trackbar)")
    p.add_argument("--mask", default="nonocc", choices=["none", "nonocc", "disc"])
    p.add_argument("--frames", type=int, default=1, help="frames to process")
    p.add_argument("--timed", action="store_true", help="per-stage timing monitors")
    p.add_argument("--pipeline", action="store_true",
                   help="double-buffered streaming: overlap decode/upload/dispatch "
                        "with device compute (video throughput mode)")
    p.add_argument("--out", default=None, help="directory for mosaic PNGs")
    p.add_argument("--device", default=None,
                   help="torch device of the engines (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="profile the frames; write DIR/trace.json (Chrome trace: "
                        "kernels and the program's psm.* spans)")

    sub = p.add_subparsers(dest="command", required=True)

    s_img = sub.add_parser("image", help="Use images as the input source.")
    s_img.add_argument("-l", "--left", help="Left image filename.")
    s_img.add_argument("-r", "--right", help="Right image filename.")
    s_img.add_argument("-g", "--gt", help="Ground truth image filename.")
    s_img.add_argument("--gt-scale", type=int, default=4)
    s_img.add_argument("--dataset", default="Cones", choices=sorted(DATASETS),
                       help="bundled Middlebury dataset (default: Cones)")
    s_img.add_argument("--all-datasets", action="store_true",
                       help="evaluate every bundled dataset")

    s_vid = sub.add_parser("video", help="Use video as the input source.")
    s_vid.add_argument("--source", default="synthetic",
                       help="'synthetic', a dir of side-by-side frames, or '<dir>:pairs'")
    s_vid.add_argument("--calib-dir", default=None,
                       help="directory with intrinsics.yml/extrinsics.yml to rectify")
    s_vid.add_argument("--calib-size", default="1280x720",
                       help="native WxH of the calibration files")
    s_vid.add_argument("--RECALIBRATE", action="store_true",
                       help="run chessboard calibration before streaming "
                            "(needs --chessboard-dir with *_left/*_right pairs)")
    s_vid.add_argument("--RECAPTURE", action="store_true",
                       help="(needs a live camera; not available headless)")
    s_vid.add_argument("--chessboard-dir", default=None,
                       help="directory of captured chessboard pairs for RECALIBRATE")
    s_vid.add_argument("--pattern", default="9x6",
                       help="chessboard inner-corner pattern (reference: 9x6)")
    s_vid.add_argument("--imagelist", default=None,
                       help="cv::FileStorage imagelist (XML/YML) of interleaved "
                            "L/R chessboard filenames, resolved relative to the "
                            "list file (reference: data/stereo_calib.xml, "
                            "readStringList src/StereoCalib.cpp:349)")
    return p


def _run(app: StereoMatchApp, frames: int, out_dir: str | None,
         pipeline: bool = False, interactive: bool = False) -> int:
    if out_dir:
        pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)

    # live HCI between frames (reference key loop src/main.cpp:80-198):
    # pump() drains stdin and applies a/m/o/s/d/-/= toggles; 'q' stops
    keys = None
    if interactive:
        from primestereomatch_torch.hci import KeyLoop

        keys = KeyLoop(app)

    def emit(res):
        print(app.report(res))
        if out_dir:
            from primestereomatch_torch.utils.display import save_png

            save_png(f"{out_dir}/frame_{res.frame_index:04d}.png", app.mosaic(res))

    if pipeline:
        for res in app.stream(frames):
            emit(res)
            if keys is not None and not keys.pump():
                break
        return 0
    for _ in range(frames):
        try:
            res = app.compute()
        except StopIteration:
            break
        emit(res)
        if keys is not None and not keys.pump():
            break
    return 0


def _recalibrate(args) -> int:
    """The reference's calibrateCamera() flow (src/StereoCalib.cpp:364,49),
    headless: detect corners in saved pairs, solve, write YMLs into
    --calib-dir (default: calib_out beside the inputs)."""
    from primestereomatch_torch.calib import calibrate_stereo_from_images
    from primestereomatch_torch.utils.video import read_image

    if args.imagelist:
        # reference flow: interleaved L,R,L,R filename list
        # (src/StereoCalib.cpp:67-72 consumes goodImageList pairwise)
        from primestereomatch_torch.calib.ymlio import read_imagelist

        lst = pathlib.Path(args.imagelist)
        names = read_imagelist(str(lst))
        if len(names) < 2:
            print(f"no image names in {lst}", file=sys.stderr)
            return 1
        base = lst.parent
        paths = [base / n for n in names]
        pairs = list(zip(paths[0::2], paths[1::2]))
    else:
        base = pathlib.Path(args.chessboard_dir)
        pairs = [
            (lp, lp.with_name(lp.name.replace("_left", "_right")))
            for lp in sorted(base.glob("*_left.*"))
        ]
        pairs = [(l, r) for l, r in pairs if r.exists()]
    if not pairs:
        print("no chessboard pairs found", file=sys.stderr)
        return 1
    l_imgs = [read_image(str(l)) for l, _ in pairs]
    r_imgs = [read_image(str(r)) for _, r in pairs]
    h, w = l_imgs[0].shape[:2]
    cols, rows_ = (int(v) for v in args.pattern.lower().split("x"))
    out_dir = args.calib_dir or str(base / "calib_out")
    try:
        res = calibrate_stereo_from_images(
            l_imgs, r_imgs, (w, h), pattern_size=(cols, rows_), out_dir=out_dir
        )
    except ValueError as e:    # too few usable chessboard pairs
        print(f"calibration failed: {e}", file=sys.stderr)
        return 1
    print(
        f"calibrated from {res.n_views_used} pairs | reprojection RMS "
        f"{res.calib.rms:.3f}px | epipolar RMS {res.epipolar_rms:.3f}px | "
        f"wrote {res.intrinsics_path}, {res.extrinsics_path}"
    )
    args.calib_dir = out_dir
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    base = dict(
        alg=args.alg, max_dis=args.max_dis, subsample=args.subsample,
        med_sz=args.med_sz, error_threshold=args.threshold,
        mask_mode=args.mask, timed=args.timed, out_dir=args.out,
        device=args.device,
    )

    tracing = trace(args.trace) if args.trace else contextlib.nullcontext()
    if args.command == "image":
        names = sorted(DATASETS) if args.all_datasets else [args.dataset]
        rc = 0
        with tracing:
            for name in names:
                cfg = AppConfig(
                    media_mode="image", dataset=name,
                    left=args.left, right=args.right, gt=args.gt,
                    gt_scale=args.gt_scale, **base,
                )
                app = StereoMatchApp(cfg)
                # the reference key loop runs in image mode too
                # (src/main.cpp:80-198 polls regardless of media mode)
                rc |= _run(app, args.frames, args.out, args.pipeline,
                           interactive=True)
        return rc

    if args.RECAPTURE:
        print(
            "Chessboard capture requires a live camera; save captured pairs "
            "to a directory and pass --RECALIBRATE --chessboard-dir instead.",
            file=sys.stderr,
        )
        return 1
    if args.RECALIBRATE:
        if not args.chessboard_dir and not args.imagelist:
            print("--RECALIBRATE needs --chessboard-dir or --imagelist",
                  file=sys.stderr)
            return 1
        rc = _recalibrate(args)
        if rc:
            return rc
    cw, ch = (int(v) for v in args.calib_size.lower().split("x"))
    cfg = AppConfig(
        media_mode="video", video_source=args.source,
        calib_dir=args.calib_dir, calib_size=(cw, ch), **base,
    )
    app = StereoMatchApp(cfg)
    with tracing:
        return _run(app, args.frames, args.out, args.pipeline, interactive=True)


if __name__ == "__main__":
    raise SystemExit(main())
