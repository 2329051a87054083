"""ctypes bindings for the native trie data path (``native/treekit.cpp``).

Counterpart of ``dynamictreeattn_tpu/tries/_native.py``, with the same
functions. The library is compiled with ``g++`` at its first use (never at
import) into ``tries/build/`` (listed in .gitignore), named by a hash of the
source, so an edited source is rebuilt; it is compiled to a temporary file
and moved into place (``os.replace``), so processes that build at once all
succeed. The committed ``native/libtreekit.so`` is neither read nor
written. ``DTA_NO_NATIVE=1`` selects the numpy paths of ``tries/`` (the
oracle the tests hold these functions against). Unlike the JAX package, a
failed build does not fall back silently: it raises with the compiler's
message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["accumulate_up", "block_meta_core", "endpoints_core", "flatten_core", "get_lib", "lcp_adjacent",
           "native_enabled", "seq_paths_core"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "treekit.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def native_enabled() -> bool:
    """Whether ``tries/`` takes the native paths: unless ``DTA_NO_NATIVE=1``
    (the library is then built, or the build raises)."""
    if os.environ.get("DTA_NO_NATIVE", "") == "1":
        return False
    get_lib()
    return True


def lib_path() -> Path:
    return BUILD_DIR / f"libtreekit_{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} failed ({e}); set DTA_NO_NATIVE=1 for the numpy paths") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (g++ exited {proc.returncode}):\n{proc.stderr}\n"
                           "set DTA_NO_NATIVE=1 for the numpy paths")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            so = lib_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.tk_lcp_adjacent.argtypes = [_i32p, _i64p, _i64, _i64p]
            lib.tk_flatten.argtypes = [_i32p, _i64p, _i64p, _i64, _i32p, _i32p, _i32p, _i32p]
            lib.tk_flatten.restype = _i64
            lib.tk_accumulate_up.argtypes = [_i32p, _i64, _f64p, _f64p]
            lib.tk_block_counts.argtypes = [_i32p, _i64, _i64, _i64, _i32p, _i32p]
            lib.tk_block_fill.argtypes = [_i32p, _i64, _i64, _i64, _i64, _i64, _i32p, _i32p, _i32p, _i32p]
            lib.tk_endpoints.argtypes = [_i64p, _i64p, _i64, _i64p, _i64p, _i64, _i64p]
            lib.tk_seq_paths.argtypes = [_i32p, _i64p, _i64p, _i64, _i64, _i32p]
            _LIB = lib
    return _LIB


def _flat_offsets(seqs):
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    flat = np.concatenate(seqs).astype(np.int32) if seqs and offsets[-1] > 0 else np.zeros(0, np.int32)
    return np.ascontiguousarray(flat), offsets


def lcp_adjacent(seqs) -> np.ndarray:
    """Adjacent LCP lengths [len(seqs) - 1] int64."""
    lib = get_lib()
    flat, offsets = _flat_offsets(seqs)
    out = np.zeros(max(0, len(seqs) - 1), dtype=np.int64)
    if len(seqs) > 1:
        lib.tk_lcp_adjacent(flat, offsets, len(seqs), out)
    return out


def flatten_core(seqs, lcps: np.ndarray):
    """(tokens, depth, parent, last_desc) int32 of the packed DFS layout of
    sorted `seqs` with adjacent LCPs `lcps`."""
    lib = get_lib()
    flat, offsets = _flat_offsets(seqs)
    n = int(offsets[-1] - lcps.sum())
    tokens, depth, parent, last_desc = (np.empty(n, np.int32) for _ in range(4))
    wrote = lib.tk_flatten(flat, offsets, np.ascontiguousarray(lcps, np.int64), len(seqs), tokens, depth, parent,
                           last_desc)
    if wrote != n:
        raise AssertionError(f"treekit placed {wrote} tokens, expected {n}")
    return tokens, depth, parent, last_desc


def accumulate_up(parent: np.ndarray, acc_a: np.ndarray, acc_b: np.ndarray) -> None:
    """acc[parent[j]] += acc[j] in one reverse sweep, both float64 arrays in place."""
    get_lib().tk_accumulate_up(np.ascontiguousarray(parent, np.int32), len(parent), acc_a, acc_b)


def block_meta_core(last_desc: np.ndarray, bq: int, bk: int, min_kv_slots: int = 0, min_q_slots: int = 0):
    """(kv_ids, kv_counts, kv_types, q_ids, q_counts, q_types) int32."""
    lib = get_lib()
    ld = np.ascontiguousarray(last_desc, np.int32)
    n = len(ld)
    nq, nk = n // bq, n // bk
    kv_counts, q_counts = np.zeros(nq, np.int32), np.zeros(nk, np.int32)
    lib.tk_block_counts(ld, n, bq, bk, kv_counts, q_counts)
    kv_w = max(int(kv_counts.max()), min_kv_slots, 1)
    q_w = max(int(q_counts.max()), min_q_slots, 1)
    kv_ids, kv_types = np.zeros((nq, kv_w), np.int32), np.zeros((nq, kv_w), np.int32)
    q_ids, q_types = np.zeros((nk, q_w), np.int32), np.zeros((nk, q_w), np.int32)
    lib.tk_block_fill(ld, n, bq, bk, kv_w, q_w, kv_ids, kv_types, q_ids, q_types)
    return kv_ids, kv_counts, kv_types, q_ids, q_counts, q_types


def endpoints_core(seqs, lcps: np.ndarray, q_leaf: np.ndarray, q_len: np.ndarray) -> np.ndarray:
    """Packed position int64 of each (leaf, length) attachment's last token
    (the queries sorted by leaf)."""
    lib = get_lib()
    _, offsets = _flat_offsets(seqs)
    out = np.empty(len(q_leaf), np.int64)
    lib.tk_endpoints(offsets, np.ascontiguousarray(lcps, np.int64), len(seqs), np.ascontiguousarray(q_leaf, np.int64),
                     np.ascontiguousarray(q_len, np.int64), len(q_leaf), out)
    return out


def seq_paths_core(parent: np.ndarray, end_pos: np.ndarray, seq_lens: np.ndarray, lmax: int) -> np.ndarray:
    """[S, lmax] int32 packed root → endpoint paths, -1 padded."""
    lib = get_lib()
    S = len(end_pos)
    paths = np.full((S, max(lmax, 1)), -1, np.int32)
    if S and lmax:
        lib.tk_seq_paths(np.ascontiguousarray(parent, np.int32), np.ascontiguousarray(end_pos, np.int64),
                         np.ascontiguousarray(seq_lens, np.int64), S, lmax, paths)
    return paths
