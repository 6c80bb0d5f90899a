"""Build and bind the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library, loaded with ctypes (one
source may hold the entries of two kernels: `segmin` is in `speckle.cu`,
K3's participation-weight mode `wmf_valid` in `wmf.cu`, K7's sweeps
`sgbm_sweep` and their launch plan `sgbm_sweep_plan` in `sgbm_scan.cu`). The
build runs at first use, from the sources in the package only, into
`build/torch_kernels/` beside the package; a library's file name carries
a hash of its source, the shared headers (`csrc/*.cuh`) and the flags, so
an edited source or header is rebuilt. `build()` starts one `nvcc` per
source, all at once.

`-fmad=false` keeps every multiply and add separately rounded, so the
kernels follow their plain PyTorch versions' arithmetic step for step;
`--use_fast_math` is never used (its `__expf` would move the JointWMF
weights).

Launch counts: each wrapper adds one to `LAUNCHES[name]` where it launches
its kernel, and nowhere else; K7 counts both its designs' launches in
`LAUNCHES["sgbm_scan"]`, and the image sweeps they make in
`SWEEPS["sgbm_scan"]`.
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

MAX_SMEM_BYTES = 227 * 1024       # shared memory a block may use on Hopper
SM_SMEM_BYTES = 228 * 1024        # of an SM, 1 KB of it reserved per resident block
_FNS: dict = {}                    # bound C entry points, by kernel name
BUILD_LOGS: dict[str, str] = {}    # nvcc/ptxas output per kernel, for reports

_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# C signatures: pointers and the stream as void*, sizes as int
_ARGTYPES = {
    "lowmaps": ("psm_lowmaps", [_VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP]),
    "wta": ("psm_upsample_wta", [_VP] * 7 + [_I] * 8 + [_VP]),
    "cvc_lowmaps": ("psm_cvc_lowmaps",
                    [_VP] * 6 + [_I] * 7 + [_F] + [_I] + [_F] * 5 + [_VP]),
    "cvc_wta": ("psm_cvc_wta",
                [_VP] * 10 + [_I] * 7 + [_F] + [_I] * 4 + [_F] * 5 + [_VP]),
    "wmf": ("psm_joint_wmf", [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP]),
    "wmf_valid": ("psm_joint_wmf_valid", [_VP] * 5 + [_I] * 5 + [_F, _VP]),
    "bt_cost": ("psm_bt_cost", [_VP, _VP, _VP] + [_I] * 8 + [_VP]),
    "sgbm_scan": ("psm_sgm_scan",
                  [_VP, _I, _I] + [_VP, _I, _I, _I, _I] * 2 + [_I] * 6 + [_VP]),
    "sgbm_sweep": ("psm_sgm_sweep", [_VP] + [_VP, _I] * 2 + [_I] * 5 + [_VP, _VP, _U, _VP]),
    "sgbm_sweep_plan": ("psm_sgm_sweep_plan", [_I] * 2 + [_VP]),
    "select": ("psm_select_disparity", [_VP, _VP, _I, _VP] + [_I] * 9 + [_VP]),
    "speckle": ("psm_speckle_sweep", [_VP] * 5 + [_I] * 7 + [_VP]),
    "segmin": ("psm_segmin_sweep", [_VP] * 3 + [_I] * 7 + [_VP]),
}
# kernels whose entry lives in another kernel's source
_SOURCE = {"segmin": "speckle", "wmf_valid": "wmf", "sgbm_sweep": "sgbm_scan",
           "sgbm_sweep_plan": "sgbm_scan"}
NAMES = tuple(_ARGTYPES)
SOURCES = tuple(dict.fromkeys(_SOURCE.get(n, n) for n in NAMES))
LAUNCHES = {name: 0 for name in NAMES}
SWEEPS = {"sgbm_scan": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, SWEEPS):
        for name in counts:
            counts[name] = 0


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


def _lib_path(name: str, source: pathlib.Path | None = None) -> pathlib.Path:
    src = (source or CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names=NAMES) -> float:
    """Compile every library of `names` that is missing, one nvcc process
    per source, all running at once. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    sources = dict.fromkeys(_SOURCE.get(n, n) for n in names)
    todo = [n for n in sources if not _lib_path(n).exists()]
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


def build_variants(name: str, variants: dict, source: str | None = None) -> dict:
    """Kernel `name`'s source (or the file `source`, such as an earlier
    commit's copy of it) compiled once per entry of `variants` (key ->
    extra nvcc flags, its -D knobs), the missing ones all at once, for the
    scripts that time shapes other than the shipped one. Returns the bound
    C entry per key; the compiler's output goes to
    BUILD_LOGS[f"{name} {key}"]."""
    src_name = _SOURCE.get(name, name)
    src = pathlib.Path(source) if source else CSRC / f"{src_name}.cu"
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for key, flags in variants.items():
        tag = hashlib.sha256(" ".join(flags).encode()).hexdigest()[:8]
        libs[key] = out_dir / f"{_lib_path(src_name, src).stem}-{tag}.so"
        if not libs[key].exists():
            tmp = f"{libs[key]}.{os.getpid()}.tmp"
            procs[key] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (tmp, proc) in procs.items():
        log = BUILD_LOGS[f"{name} {key}"] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {key}:\n{log}")
        os.replace(tmp, libs[key])
    fn_name, argtypes = _ARGTYPES[name]
    fns = {}
    for key, so in libs.items():
        fn = getattr(ctypes.CDLL(str(so)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[key] = fn
    return fns


def library(name: str) -> pathlib.Path:
    """The path of the shared library that holds kernel `name`, built at
    first use."""
    build((name,))
    return _lib_path(_SOURCE.get(name, name))


def load(name: str):
    """The bound C entry point of kernel `name`, built at first use."""
    if name not in _FNS:
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(ctypes.CDLL(str(library(name))), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def check(name: str, rc: int) -> None:
    """Raise on the cudaError_t the C entry returned after its launch."""
    if rc:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: cudaError {rc}")
