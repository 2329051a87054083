"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so a
build takes seconds). It is compiled at first use for ``sm_90a`` into
``csrc/build/`` (listed in .gitignore), named by a hash of the source and the
``csrc/`` headers it includes (``hopper.cuh``) so an edited source or header
is rebuilt, and loaded with ``ctypes``. Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code. Kernels launch on the caller's current stream and allocate
nothing: the Python wrappers allocate with ``torch.empty``.

Launch counts: each kernel wrapper calls :func:`count_launch` once per kernel
launch, so a run can show that its main path went through the kernels. While
a CUDA graph is captured (:func:`captured_launches`) nothing runs, so the
counts go to the capture's own tally, and whoever replays the graph adds that
tally once per replay (:func:`add_launches`). The tree-attention forward is
one kernel whose branch, bound (K1) or online (K2), the card may choose
(``tree_attention._fwd_dispatch``): each of its launches records the branch
it took in a small int32 record on the device (:func:`branch_record`), and
:func:`launches` and :func:`fwd_branches` read it, after a synchronize, only
when asked.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from dynamictreeattn_tpu_torch.utils.profiling import span

__all__ = ["FWD_BRANCHES", "KERNEL_SOURCES", "LAUNCHES", "RECORD_CAP", "add_launches", "branch_record",
           "build", "captured_launches", "check", "count_launch", "fwd_branches", "launches", "load",
           "reset_launches"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNEL_SOURCES = ("tree_attn_fwd", "tree_attn_bwd", "tree_attn_bwd_kmajor", "lm_stats_fwd", "lm_stats_bwd",
                  "qk_prep", "decode_attn", "adamw", "fused_norm_act")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> launches since the last reset_launches(), counted on the
# host (the forward's two branches are counted on the card: see launches())
LAUNCHES: dict[str, int] = {
    "tree_attn_bwd_dq": 0,
    "tree_attn_bwd_dkv": 0, "tree_attn_bwd_cached": 0, "tree_attn_bwd_fused": 0,
    "lm_stats_fwd": 0, "lm_stats_bwd": 0, "qk_prep_fwd_q": 0, "qk_prep_fwd_kv": 0,
    "qk_prep_bwd_q": 0, "qk_prep_bwd_kv": 0, "decode_attn": 0, "adamw_sum_squares": 0, "adamw_update": 0,
    "rms_norm_fwd": 0, "rms_norm_bwd": 0, "swiglu_fwd": 0, "swiglu_bwd": 0,
}
_LIBS: dict[str, ctypes.CDLL] = {}
_CAPTURED: dict[str, int] | None = None  # the tally of the capture under way
# the forward kernel's branch codes (0 online, 1 bound) -> kernel names
FWD_BRANCHES = ("tree_attn_fwd_online", "tree_attn_fwd_bound")
# branches the record keeps one by one (the counts go on past it)
RECORD_CAP = 1 << 16
_RECORDS: dict[torch.device, torch.Tensor] = {}


def branch_record(device) -> torch.Tensor:
    """The int32 [2 + RECORD_CAP] record of the forward's launches on the
    CUDA `device`: [0] launches since the last reset, [1] those that took the
    bound branch, [2 + i % RECORD_CAP] the branch code of launch i. One
    thread of each launch writes it, at the index it takes from [0]."""
    device = torch.device(device)
    rec = _RECORDS.get(device)
    if rec is None:
        with torch.inference_mode(False):  # a first launch under inference mode: reset outside it
            rec = _RECORDS[device] = torch.zeros(2 + RECORD_CAP, dtype=torch.int32, device=device)
    return rec


def _read_records() -> list[list[int]]:
    if any(rec.is_cuda for rec in _RECORDS.values()):
        torch.cuda.synchronize()
    return [rec.tolist() for rec in _RECORDS.values()]


def fwd_branches() -> list[str]:
    """The kernel name of each forward launch since the last reset, in launch
    order (the last RECORD_CAP of each device's). Synchronises."""
    out = []
    for rec in _read_records():
        n = rec[0]
        out += [FWD_BRANCHES[rec[2 + i % RECORD_CAP]] for i in range(max(0, n - RECORD_CAP), n)]
    return out


def launches() -> dict[str, int]:
    """Launches since the last reset_launches(): LAUNCHES with the forward's
    two branches read from the device records. Synchronises."""
    counts = {name: 0 for name in FWD_BRANCHES}
    for rec in _read_records():
        counts["tree_attn_fwd_bound"] += rec[1]
        counts["tree_attn_fwd_online"] += rec[0] - rec[1]
    return {**counts, **LAUNCHES}


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
    for rec in _RECORDS.values():
        rec[:2].zero_()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """`path` and every ``#include "..."`` it reaches, each once, in the
    order first met."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for name in _LOCAL_INCLUDE.findall(text):
            _sources(path.parent / name.decode(), seen)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path, text in _sources(CSRC / f"{name}.cu", {}).items():
        h.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every source of `names` not yet built, all nvcc processes at
    once. Returns {name: compiler output} (ptxas register / shared-memory
    report) for the sources compiled by this call; raises on a failed build.
    The wait for each source's compile is a host span "build.<name>"
    (``utils.profiling``): a trace of the set-up shows which were built."""
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
        with span(f"build.{name}"):
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
