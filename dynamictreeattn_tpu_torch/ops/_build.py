"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so a
build takes seconds). It is compiled at first use for ``sm_90a`` into
``csrc/build/`` (listed in .gitignore), named by a hash of the source so an
edited source is rebuilt, and loaded with ``ctypes``. Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code. Kernels launch on the caller's current stream and allocate
nothing: the Python wrappers allocate with ``torch.empty``.

Launch counts: each kernel wrapper calls :func:`count_launch` once per kernel
launch, so a run can show that its main path went through the kernels. While
a CUDA graph is captured (:func:`captured_launches`) nothing runs, so the
counts go to the capture's own tally, and whoever replays the graph adds that
tally once per replay (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "LAUNCHES", "add_launches", "build", "captured_launches", "check",
           "count_launch", "load", "reset_launches"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNEL_SOURCES = ("tree_attn_fwd", "tree_attn_bwd", "tree_attn_bwd_fused", "tree_attn_bwd_kmajor",
                  "lm_stats_fwd", "lm_stats_bwd", "qk_prep", "decode_attn")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "tree_attn_fwd_bound": 0, "tree_attn_fwd_online": 0, "tree_attn_bwd_dq": 0,
    "tree_attn_bwd_dkv": 0, "tree_attn_bwd_cached": 0, "tree_attn_bwd_fused": 0,
    "lm_stats_fwd": 0, "lm_stats_bwd": 0, "qk_prep_fwd_q": 0, "qk_prep_fwd_kv": 0,
    "qk_prep_bwd_q": 0, "qk_prep_bwd_kv": 0, "decode_attn": 0,
}
_LIBS: dict[str, ctypes.CDLL] = {}
_CAPTURED: dict[str, int] | None = None  # the tally of the capture under way


def count_launch(name: str) -> None:
    if _CAPTURED is None:
        LAUNCHES[name] += 1
    else:
        _CAPTURED[name] = _CAPTURED.get(name, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """Inside: launches are captured, not run; they count into the yielded
    dict and not into LAUNCHES."""
    global _CAPTURED
    outer, _CAPTURED = _CAPTURED, {}
    try:
        yield _CAPTURED
    finally:
        _CAPTURED = outer


def add_launches(counts: dict[str, int]) -> None:
    """One replay of a graph whose capture counted `counts`."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every source of `names` not yet built, all nvcc processes at
    once. Returns {name: compiler output} (ptxas register / shared-memory
    report) for the sources compiled by this call; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
