"""Build and bind the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library, loaded with ctypes. The
build runs at first use, from the sources in the package only, into
`build/torch_kernels/` beside the package; a library's file name carries
a hash of its source and flags, so an edited source is rebuilt. `build()`
starts one `nvcc` per source, all at once.

`-fmad=false` keeps every multiply and add separately rounded, so the
kernels follow their plain PyTorch versions' arithmetic step for step;
`--use_fast_math` is never used (its `__expf` would move the JointWMF
weights).

Launch counts: each wrapper adds one to `LAUNCHES[name]` where it launches
its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_FNS: dict = {}                    # bound C entry points, by kernel name
BUILD_LOGS: dict[str, str] = {}    # nvcc/ptxas output per kernel, for reports

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers and the stream as void*, sizes as int
_ARGTYPES = {
    "lowmaps": ("psm_lowmaps", [_VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP]),
    "wta": ("psm_upsample_wta",
            [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP]),
    "wmf": ("psm_joint_wmf", [_VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP]),
}
NAMES = tuple(_ARGTYPES)
LAUNCHES = {name: 0 for name in NAMES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> pathlib.Path:
    return CSRC.parents[1] / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=NAMES) -> float:
    """Compile every library of `names` that is missing, one nvcc process
    per source, all running at once. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out_dir / f"{_lib_path(n).name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        BUILD_LOGS[n] = proc.communicate()[0]
        if proc.returncode:
            failed.append(n)
        else:
            os.replace(tmp, _lib_path(n))   # atomic: a concurrent build is harmless
    if failed:
        logs = "\n".join(f"--- {n} ---\n{BUILD_LOGS[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def load(name: str):
    """The bound C entry point of kernel `name`, built at first use."""
    if name not in _FNS:
        build((name,))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def check(name: str, rc: int) -> None:
    """Raise on the cudaError_t the C entry returned after its launch."""
    if rc:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: cudaError {rc}")
