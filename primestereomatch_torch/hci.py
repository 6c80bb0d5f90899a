"""Runtime HCI: the reference's live keyboard loop, headless (own copy of the
JAX package's hci.py).

The reference's main thread polls `waitKey(1)` while the compute thread
free-runs, mutating the engine between frames (src/main.cpp:80-198). Here
the same keys are polled from stdin between frames of a run, driving the
existing `StereoMatchApp` setters:

  h  help + current options            (src/main.cpp:100-126)
  q  quit                              (src/main.cpp:96)
  a  STEREO_GIF <-> STEREO_SGBM        (src/main.cpp:128-133)
  d  cycle Middlebury dataset          (src/main.cpp:134-149, image mode only)
  m  GIF: the CUDA card (the kernels) <-> the CPU (their plain versions),
                                       the OpenCL <-> pthreads analog
                                       (src/main.cpp:152-159)
     SGBM: MODE_HH -> MODE_SGBM -> MODE_SGBM_3WAY (src/main.cpp:160-169)
  o  cycle error mask none/nonocc/disc (src/main.cpp:171-184)
  s  subsample rate 2 -> 4 -> 8 -> 2   (src/main.cpp:186-193)
  1-8  CPU threads of the plain path   (the live thread-count keys,
                                        src/main.cpp:96-195:
                                        torch.set_num_threads(k); the
                                        kernels on the card do not change)
  -/=  error threshold down/up         (the trackbar, src/main.cpp:91-93)

Keys are line-buffered on a terminal (type the key then Enter): a raw
tty mode would steal the terminal from logging; the reference has a GUI
window to capture keystrokes instead.
"""

from __future__ import annotations

import sys
from typing import Callable

import torch

from primestereomatch_torch.utils.datasets import DATASETS

_DATASET_CYCLE = sorted(DATASETS)


def _stdin_reader() -> str:
    """Drain whatever is pending on stdin without blocking ('' if nothing)."""
    import select

    try:
        fd = sys.stdin.fileno()
    except (OSError, ValueError, AttributeError):
        return ""
    out = []
    while True:
        ready, _, _ = select.select([fd], [], [], 0)
        if not ready:
            break
        chunk = sys.stdin.readline()
        if not chunk:       # EOF (closed pipe): stop polling forever
            break
        out.append(chunk)
    return "".join(out)


class KeyLoop:
    """Dispatch reference HCI keys onto a StereoMatchApp.

    `reader` returns pending input characters ('' when none); tests pass
    a canned feeder, the CLI uses the non-blocking stdin drain.
    """

    def __init__(self, app, reader: Callable[[], str] | None = None,
                 echo: Callable[[str], None] = print):
        self.app = app
        self.reader = reader or _stdin_reader
        self.echo = echo
        self._dataset_idx = 0

    # -- per-key handlers ---------------------------------------------------

    def _key_h(self):
        a = self.app
        mode = (
            f"device={a.gif_device.type}"
            if a.cfg.alg == "STEREO_GIF" else f"sgbm_mode={a.sgbm_cfg.mode}"
        )
        self.echo(
            "| h: help | q: quit | a: algorithm | d: dataset | m: mode |\n"
            "| o: error mask | s: subsample | -/=: error threshold |\n"
            "| 1-8: CPU threads of the plain path (thread-count keys) |\n"
            f"| current: alg={a.cfg.alg} {mode} mask={a.cfg.mask_mode} "
            f"s={a.cfg.subsample} thr={a.cfg.error_threshold} "
            f"threads={torch.get_num_threads()}"
        )

    def _key_a(self):
        nxt = "STEREO_SGBM" if self.app.cfg.alg == "STEREO_GIF" else "STEREO_GIF"
        self.app.set_algorithm(nxt)
        self.echo(f"| a: Matching Algorithm Changed to: {nxt} |")

    def _key_d(self):
        if self.app.cfg.media_mode == "video":
            self.echo("| d: Must be in image mode to use datasets.")
            return
        if self.app.cfg.left:
            self.echo("| d: User dataset has been specified.")
            return
        self._dataset_idx = (self._dataset_idx + 1) % len(_DATASET_CYCLE)
        name = _DATASET_CYCLE[self._dataset_idx]
        self.app.update_dataset(name)
        self.echo(f"| d: Dataset changed to: {name}")

    def _key_m(self):
        if self.app.cfg.alg == "STEREO_GIF":
            dev = self.app.toggle_gif_device()
            self.echo(f"| m: STEREO_GIF kernels changed to {dev} |")
        else:
            mode = self.app.toggle_sgbm_mode()
            name = {"hh": "MODE_HH", "sgbm": "MODE_SGBM", "3way": "MODE_SGBM_3WAY"}
            self.echo(f"| m: Mode changed to {name[mode]} |")

    def _key_o(self):
        sample = getattr(self.app, "_sample", None)
        if sample is not None and sample.mask_nonocc is None:
            self.echo("| o: Disparity error masks not provided for the chosen dataset.")
            return
        cur = self.app.cfg.mask_mode
        nxt = {"none": "nonocc", "nonocc": "disc", "disc": "none"}[cur]
        self.app.set_mask_mode(nxt)
        self.echo(f"| o: Disparity error mask set to: {nxt.capitalize()} |")

    def _key_s(self):
        s = self.app.cfg.subsample * 2
        if s > 8:
            s = 2
        self.app.set_subsample(s)
        self.echo(f"| s: Subsample rate changed to {s}.")

    def _key_thr(self, delta: int):
        t = max(0, min(64, self.app.cfg.error_threshold + delta))
        self.app.cfg.error_threshold = t
        self.echo(f"| threshold: Error Threshold changed to {t}.")

    def _key_digit(self, level: int):
        # reference '1'-'8': live CPU thread count (src/main.cpp:96-195)
        n = self.app.set_parallelism(level)
        self.echo(
            f"| {level}: CPU threads of the plain path changed to {n}; "
            "the kernels on the card do not change. |"
        )

    # -- loop ---------------------------------------------------------------

    def handle(self, key: str) -> bool:
        """Apply one key. Returns False when the run should stop ('q')."""
        if key == "q":
            return False
        if key in "12345678":
            self._key_digit(int(key))
            return True
        fn = {
            "h": self._key_h, "a": self._key_a, "d": self._key_d,
            "m": self._key_m, "o": self._key_o, "s": self._key_s,
            "-": lambda: self._key_thr(-1), "=": lambda: self._key_thr(+1),
        }.get(key)
        if fn is not None:
            fn()
        return True

    def pump(self) -> bool:
        """Drain pending input and apply every key. False -> quit."""
        for ch in self.reader():
            if not ch.isspace() and not self.handle(ch):
                return False
        return True
