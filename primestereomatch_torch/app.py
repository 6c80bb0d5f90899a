"""Application orchestrator: the reference StereoMatch layer, headless (own
copy of the JAX package's app.py, on PyTorch).

Maps the reference's L4 orchestrator (src/StereoMatch.cpp) onto a
library-friendly engine:

  * media modes DE_IMAGE / DE_VIDEO (StereoMatch.h:16-17) -> 'image'/'video'
  * per-frame capture -> (rectify+crop) -> algorithm dispatch -> GT eval ->
    display mosaic (compute, src/StereoMatch.cpp:118-318)
  * dataset switching (update_dataset, :528-608)
  * runtime toggles: algorithm, mask mode, subsample rate, error threshold
    (the reference's HCI keys, src/main.cpp:96-195)
  * per-stage timing monitors (:209-242, 255-268)

The engines run on `AppConfig.device` (None: the CUDA card; the app raises
at construction without one). Frames go to the device as uint8, are
rectified there (`calib.Rectifier`) and scaled to float32 there; results
come back as numpy arrays. `stream()` overlaps the host's decode, upload
and dispatch of frame n+1 with frame n on the device, through pinned
staging buffers and CUDA events.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from primestereomatch_torch.config import GIFConfig, SGBMConfig
from primestereomatch_torch.models import (
    DispEst,
    sgbm_display_u8,
    stereo_gif_forward,
    stereo_sgbm_forward,
)
from primestereomatch_torch.ops.sgbm import SPECKLE_SWEEPS
from primestereomatch_torch.utils.datasets import (
    DATASETS,
    MASK_DISC,
    MASK_NONE,
    MASK_NONOCC,
    StereoSample,
    load_dataset,
)
from primestereomatch_torch.utils.device import resolve_device
from primestereomatch_torch.utils.display import build_mosaic, disp_to_u8
from primestereomatch_torch.utils.eval import BPResult, bad_pixel_metrics
from primestereomatch_torch.utils.profiling import StageTimers, span

_MASKS = {"none": MASK_NONE, "nonocc": MASK_NONOCC, "disc": MASK_DISC}
# convertTo(CV_32F, 1/255.0f): the JAX app's astype(float32) * float32(1/255)
# (app.py:249-250); a float32 constant multiplied, so the product is the
# same on the card and on the host
U8_TO_F32 = float(np.float32(1 / 255.0))
RING = 2     # pinned staging slots of stream(): frame n in flight, n+1 filling
# stream()'s host spans (utils/profiling.py::span), each closed before a yield;
# the Rectifier's and the GIF entry's open inside SPAN_DISPATCH
SPAN_READ = "psm.stream.read"          # the call into the source
SPAN_DISPATCH = "psm.stream.dispatch"  # staging, upload, scale, forward, result copies, event
SPAN_WAIT = "psm.stream.wait"          # the host blocked on frame n's event
SPAN_FETCH = "psm.stream.fetch"        # copies out of the pinned slots, the FrameResult
# compute()'s host spans (it opens SPAN_READ too): its pageable uploads, and
# the results' and matched frames' conversion to host arrays
SPAN_UPLOAD = "psm.compute.upload"
SPAN_COMPUTE_FETCH = "psm.compute.fetch"


@dataclasses.dataclass
class AppConfig:
    alg: str = "STEREO_GIF"          # required -a/--alg (src/StereoMatch.cpp:745-751)
    media_mode: str = "image"        # image | video
    dataset: str = "Cones"           # default dataset_names[2] (StereoMatch.h:28)
    left: str | None = None          # user-supplied image-mode files
    right: str | None = None
    gt: str | None = None
    gt_scale: int = 4
    max_dis: int = 64                # src/StereoMatch.cpp:30
    subsample: int = 4               # FGF s ('s' key cycles 2/4/8)
    med_sz: int = 19
    error_threshold: int = 4         # src/StereoMatch.cpp:37
    mask_mode: str = "nonocc"        # none | nonocc | disc ('o' key)
    video_source: str = "synthetic"  # video mode frame source spec
    calib_dir: str | None = None     # rectify video frames when set
    calib_size: tuple[int, int] = (1280, 720)  # native size of the shipped YMLs
    timed: bool = False              # per-stage timing monitors
    out_dir: str | None = None       # write mosaic PNGs here
    device: str | None = None        # None: the CUDA card ('cpu': plain versions)


def from_jax_app_config(fields: dict) -> AppConfig:
    """Build the port's AppConfig from `dataclasses.asdict()` of the JAX
    package's AppConfig. `device` keeps its default (the card); keys the
    JAX AppConfig does not have raise."""
    known = {f.name for f in dataclasses.fields(AppConfig)} - {"device"}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown AppConfig keys: {unknown}")
    return AppConfig(**fields)


@dataclasses.dataclass
class FrameResult:
    l_disp: np.ndarray               # (H, W) uint8 raw disparities
    r_disp: np.ndarray
    left_bgr: np.ndarray             # the matched frames (rectified crops with calib_dir)
    right_bgr: np.ndarray
    times_ms: dict[str, float]
    metrics: BPResult | None
    frame_index: int

    @property
    def fps(self) -> float:
        total = self.times_ms.get("total", sum(self.times_ms.values()))
        return 1000.0 / total if total else float("inf")


def _as_device_u8(img, dev: torch.device) -> torch.Tensor:
    """A uint8 frame (numpy, a side-by-side frame's half among them) as a
    contiguous tensor on `dev`; torch's host copy uses the host's threads."""
    return torch.from_numpy(img).contiguous().to(dev)


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class StereoMatchApp:
    def __init__(self, cfg: AppConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # the GIF engine's device: the app's, until the 'm' key moves it
        self.gif_device = self.device
        self.frame_index = 0
        self._sample: StereoSample | None = None
        self._source = None
        self._rectifier = None
        self._sgbm_mode = "hh"
        # stream()'s frames fetched, and those whose event had completed
        # when the host came to wait (the device idle before the host); the
        # K9 sweeps the speckle filter of every SGBM frame ran (compute())
        self.stream_counts = {"frames": 0, "ready_at_wait": 0, "speckle_sweeps": 0}

        if cfg.media_mode == "image":
            if cfg.left:
                from primestereomatch_torch.utils.video import read_image

                self._sample = StereoSample(
                    name="User",
                    left_bgr=read_image(cfg.left, 3),
                    right_bgr=read_image(cfg.right, 3),
                    gt=read_image(cfg.gt, 1) if cfg.gt else None,
                    mask_nonocc=None,
                    mask_disc=None,
                    scale_factor=cfg.gt_scale,
                    default_mask=MASK_NONE,
                )
            else:
                self._sample = load_dataset(cfg.dataset)
        elif cfg.media_mode == "video":
            from primestereomatch_torch.utils.video import open_source

            self._source = open_source(cfg.video_source)
            if cfg.calib_dir:
                from primestereomatch_torch.calib import load_stereo_calibration

                # the Rectifier is built from the first frame's size
                self._calib = load_stereo_calibration(
                    f"{cfg.calib_dir}/intrinsics.yml",
                    f"{cfg.calib_dir}/extrinsics.yml",
                )
        else:
            raise ValueError(f"unknown media_mode {cfg.media_mode!r}")

        self._build_engines()

    # -- engine management ---------------------------------------------------

    def _build_engines(self):
        self.gif_cfg = GIFConfig(
            max_dis=self.cfg.max_dis,
            subsample=self.cfg.subsample,
            med_sz=self.cfg.med_sz,
        )
        self.sgbm_cfg = SGBMConfig(num_disparities=self.cfg.max_dis, mode=self._sgbm_mode)
        self._dispest = DispEst(self.gif_cfg, device=self.gif_device)

    def set_algorithm(self, alg: str):
        """'a' key: toggle STEREO_GIF <-> STEREO_SGBM (src/main.cpp:103-131)."""
        if alg not in ("STEREO_GIF", "STEREO_SGBM"):
            raise ValueError(alg)
        self.cfg.alg = alg

    def toggle_sgbm_mode(self) -> str:
        """'m' key (SGBM): cycle MODE_HH -> MODE_SGBM -> MODE_SGBM_3WAY
        (src/main.cpp:161-163). Returns the new mode."""
        self._sgbm_mode = {"hh": "sgbm", "sgbm": "3way", "3way": "hh"}[self.sgbm_cfg.mode]
        self.sgbm_cfg = dataclasses.replace(self.sgbm_cfg, mode=self._sgbm_mode)
        return self._sgbm_mode

    def toggle_gif_device(self) -> str:
        """'m' key (GIF): move the GIF engine between the CUDA card (the
        hand-written kernels) and the CPU (their plain PyTorch versions),
        the analog of the reference's OpenCL <-> pthreads switch
        (src/main.cpp:152-159). Returns the new device's name; from the CPU
        without a card it refuses, as the reference does without an OpenCL
        device (src/main.cpp:157-159)."""
        if self.gif_device.type == "cuda":
            self.gif_device = torch.device("cpu")
        elif torch.cuda.is_available():
            self.gif_device = torch.device("cuda")
        else:
            return "cpu (CUDA is not available for the kernels)"
        self._build_engines()
        return self.gif_device.type

    def set_subsample(self, s: int):
        """'s' key: FGF subsample rate 2/4/8 (src/main.cpp:186-193)."""
        self.cfg.subsample = s
        self._build_engines()

    def set_parallelism(self, level: int) -> int:
        """'1'-'8' keys: the reference's live CPU thread count
        (src/main.cpp:96-195 dispatch to DispEst::setThreads; its threads
        split the same disparity loop). Level k sets torch.set_num_threads(k),
        the thread count of the plain versions on the CPU; the kernels on
        the card do not change. Returns the applied count. Results are
        invariant; only the CPU path's throughput changes."""
        if not 1 <= level <= 8:
            raise ValueError(f"parallelism level must be 1..8, got {level}")
        torch.set_num_threads(level)
        return torch.get_num_threads()

    def set_mask_mode(self, mode: str):
        """'o' key: cycle evaluation mask (src/main.cpp:172-185)."""
        if mode not in _MASKS:
            raise ValueError(mode)
        self.cfg.mask_mode = mode

    def update_dataset(self, name: str):
        """'d' key: switch Middlebury dataset (src/StereoMatch.cpp:528-608)."""
        if name not in DATASETS:
            raise ValueError(f"unknown dataset {name!r}")
        self.cfg.dataset = name
        self._sample = load_dataset(name)

    # -- per-frame compute ---------------------------------------------------

    def _read(self) -> tuple[np.ndarray, np.ndarray]:
        """The next host frame pair (raises StopIteration at the source's end)."""
        if self._sample is not None:
            return self._sample.left_bgr, self._sample.right_bgr
        return next(self._source)

    def _rectify(self, l_raw: torch.Tensor, r_raw: torch.Tensor):
        """Raw uint8 frames on the app's device -> the frames to match: the
        rectified crops with calib_dir (on the device), else the frames."""
        if not self.cfg.calib_dir:
            return l_raw, r_raw
        if self._rectifier is None:
            from primestereomatch_torch.calib import Rectifier

            h, w = l_raw.shape[:2]
            self._rectifier = Rectifier(self._calib, (w, h), calib_size=self.cfg.calib_size,
                                        device=self.device)
        return self._rectifier(l_raw, r_raw)

    def _gif_inputs(self, l_u8: torch.Tensor, r_u8: torch.Tensor):
        dev = self.gif_device
        return (t.to(dev).to(torch.float32) * U8_TO_F32 for t in (l_u8, r_u8))

    def compute(self) -> FrameResult:
        times: dict[str, float] = {}
        t_total = time.perf_counter()

        with span(SPAN_READ):
            l_in, r_in = self._read()
        with span(SPAN_UPLOAD):
            l_dev, r_dev = (_as_device_u8(x, self.device) for x in (l_in, r_in))
        l_u8, r_u8 = self._rectify(l_dev, r_dev)

        if self.cfg.alg == "STEREO_GIF":
            l_f, r_f = self._gif_inputs(l_u8, r_u8)
            if self.cfg.timed:
                e = self._dispest
                t = StageTimers(self.gif_device)
                with t.stage("CVC"):
                    lcv, rcv = e.cost_const(l_f, r_f)
                with t.stage("CVF"):
                    lcv = e.cost_filter(l_f, lcv)
                    rcv = e.cost_filter(r_f, rcv)
                with t.stage("DispSel"):
                    ld = e.disp_select(lcv)
                    rd = e.disp_select(rcv)
                del lcv, rcv
                with t.stage("PP"):
                    ld = e.post_process(ld, l_f)
                    rd = e.post_process(rd, r_f)
                times.update({k: v.last_ms for k, v in t.stages.items()})
            else:
                ld, rd = stereo_gif_forward(l_f, r_f, self.gif_cfg, device=self.gif_device)
        else:  # STEREO_SGBM
            sweeps = SPECKLE_SWEEPS["count"]
            d16 = stereo_sgbm_forward(l_u8, r_u8, self.sgbm_cfg, device=self.device)
            self.stream_counts["speckle_sweeps"] += SPECKLE_SWEEPS["count"] - sweeps
            ld, rd = sgbm_display_u8(d16, 1, self.cfg.max_dis), None
        with span(SPAN_COMPUTE_FETCH):
            l_disp = _to_numpy(ld)
            # the reference's SGBM is left-only
            r_disp = np.zeros_like(l_disp) if rd is None else _to_numpy(rd)
            # the matched frames: the host frames themselves, or the rectified
            # crops fetched with the disparities
            if self.cfg.calib_dir:
                l_in, r_in = _to_numpy(l_u8), _to_numpy(r_u8)

        times["total"] = (time.perf_counter() - t_total) * 1e3

        metrics = None
        sample = self._sample
        if sample is not None and sample.gt is not None:
            mask_mode = _MASKS[self.cfg.mask_mode]
            mask = None
            mask_is_disc = False
            if mask_mode == MASK_NONOCC and sample.mask_nonocc is not None:
                mask = sample.mask_nonocc
            elif mask_mode == MASK_DISC and sample.mask_disc is not None:
                mask = sample.mask_disc
                mask_is_disc = True
            metrics = bad_pixel_metrics(
                l_disp, sample.gt, sample.scale_factor, self.cfg.max_dis,
                error_threshold=self.cfg.error_threshold,
                mask=mask, mask_is_disc=mask_is_disc,
            )

        self.frame_index += 1
        return FrameResult(
            l_disp=l_disp, r_disp=r_disp,
            left_bgr=l_in, right_bgr=r_in,
            times_ms=times, metrics=metrics,
            frame_index=self.frame_index - 1,
        )

    def stream(self, frames: int):
        """Pipelined frame iterator: the reference's free-running compute
        thread (src/main.cpp:40-73). GIF only; SGBM (K9 reads a device flag,
        so its frames synchronise anyway) and timed runs fall back to
        compute(). Yields FrameResult; each frame equals compute()'s of the
        same input bit for bit.

        On one CUDA stream, fetching frame n after enqueueing frame n+1
        would wait for n+1, and an upload from pageable memory blocks the
        host until the stream drains. So each frame is copied into a pinned
        host slot and uploaded with non_blocking=True; after its forward,
        its disparities (and the rectified crops) are copied into pinned
        result slots, non_blocking, and a CUDA event is recorded. Frame n+1
        is dispatched before the host waits on frame n's event, and a
        result is copied out of its slot before the slot is reused (RING
        slots of each; slot n % RING is refilled only after frame n - RING's
        event was waited on). On the CPU the same code runs unpinned.

        `stream_counts` adds each fetched frame to "frames", and to
        "ready_at_wait" where its event had completed before the host came
        to wait (always on the CPU, which has no event). While a profiler
        runs, each frame records the SPAN_* spans above; frames pair with
        their spans by order, as no span is open across a yield. Either way
        the stream ends where the source ends."""
        if self.cfg.alg != "STEREO_GIF" or self.cfg.timed:
            for _ in range(frames):
                try:
                    res = self.compute()
                except StopIteration:       # the source's end, from compute()'s read
                    return
                yield res
            return

        cuda = self.device.type == "cuda"
        state = {"exhausted": False, "submitted": 0}
        slots: dict = {}

        def slot(key, shape, i):
            """The pinned host buffer `key` of ring slot i, (re)allocated
            for `shape`."""
            buf = slots.get((key, i))
            if buf is None or tuple(buf.shape) != tuple(shape):
                buf = torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
                slots[(key, i)] = buf
            return buf

        def dispatch():
            if state["exhausted"] or state["submitted"] >= frames:
                return None
            try:
                with span(SPAN_READ):
                    l_bgr, r_bgr = self._read()
            except StopIteration:
                state["exhausted"] = True
                return None
            with span(SPAN_DISPATCH):
                t0 = time.perf_counter()
                i = state["submitted"] % RING
                raw = slot("raw", (2, *l_bgr.shape), i)
                raw[0].copy_(torch.from_numpy(l_bgr))     # torch's copies use the host's threads
                raw[1].copy_(torch.from_numpy(r_bgr))
                raw_dev = raw.to(self.device, non_blocking=True)
                l_u8, r_u8 = self._rectify(raw_dev[0], raw_dev[1])
                ld, rd = stereo_gif_forward(*self._gif_inputs(l_u8, r_u8), self.gif_cfg,
                                            device=self.gif_device)
                out = {"l_disp": ld, "r_disp": rd}
                if self.cfg.calib_dir:
                    out["crops"] = torch.stack([l_u8, r_u8])
                host = {}
                for key, t in out.items():
                    host[key] = slot(key, t.shape, i)
                    host[key].copy_(t, non_blocking=True)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            state["submitted"] += 1
            idx = self.frame_index
            self.frame_index += 1
            return host, done, l_bgr, r_bgr, t0, idx

        pending = dispatch()
        emitted = 0
        while pending is not None and emitted < frames:
            nxt = dispatch()  # next frame in flight before fetching this one
            host, done, l_bgr, r_bgr, t0, idx = pending
            with span(SPAN_WAIT):
                ready = done is None or done.query()
                if not ready:
                    done.synchronize()
            with span(SPAN_FETCH):
                # copies out of the pinned slots, which a later frame reuses
                res = {key: buf.clone().numpy() for key, buf in host.items()}
                if "crops" in res:
                    l_bgr, r_bgr = res["crops"]
                dt = (time.perf_counter() - t0) * 1e3
                result = FrameResult(
                    l_disp=res["l_disp"], r_disp=res["r_disp"],
                    left_bgr=l_bgr, right_bgr=r_bgr,
                    times_ms={"total": dt}, metrics=None, frame_index=idx,
                )
            self.stream_counts["frames"] += 1
            self.stream_counts["ready_at_wait"] += ready
            yield result
            emitted += 1
            pending = nxt

    # -- output --------------------------------------------------------------

    def mosaic(self, res: FrameResult) -> np.ndarray:
        sf = self._sample.scale_factor if self._sample else 1
        gt = self._sample.gt if self._sample else None
        err = res.metrics.err_map if res.metrics else None
        return build_mosaic(
            res.left_bgr, res.right_bgr,
            disp_to_u8(res.l_disp, sf), disp_to_u8(res.r_disp, sf),
            gt=gt, err_map=err,
        )

    def report(self, res: FrameResult) -> str:
        """One status line per frame, like the reference's printf stream."""
        parts = [f"frame {res.frame_index}", f"alg {self.cfg.alg}"]
        for k, v in res.times_ms.items():
            parts.append(f"{k} {v:.1f}ms")
        if res.metrics is not None:
            parts.append(f"%BP({self.cfg.mask_mode}) {res.metrics.percent_bad_pixels:.2f}")
            parts.append(f"avgErr {res.metrics.avg_err:.2f}")
        return " | ".join(parts)
