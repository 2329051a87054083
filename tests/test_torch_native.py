"""The port's native trie bridge (``tries/_native.py`` over ``native/treekit.cpp``).

* every function equals, bit for bit, the port's numpy path
  (``DTA_NO_NATIVE=1``) and the JAX package's ``tries/_native.py`` on the
  same inputs (random tries, several block shapes and minimum slot widths);
  ``flatten_trie`` and ``seq_paths_matrix`` through the bridge equal their
  numpy paths, the float weights included;
* importing the port's ``tries`` builds nothing (a process with no compiler
  on its PATH imports every module of the package);
* two processes that build into one empty directory at once both succeed,
  and the committed ``native/libtreekit.so`` keeps its bytes and mtime;
* a build that fails raises with the compiler's message and names
  ``DTA_NO_NATIVE=1``.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu.tries import _native as jax_native
from dynamictreeattn_tpu_torch.tries import TokenTrie, _native, build_block_meta, flatten_trie
from dynamictreeattn_tpu_torch.tries.flatten import _pad_packed
from dynamictreeattn_tpu_torch.tries.token_trie import lcp_arrays

from helpers import random_trie_batch

REPO = Path(__file__).resolve().parent.parent
COMMITTED = REPO / "native" / "libtreekit.so"
FIELDS = ("tokens", "depth", "parent", "last_desc", "w_logprob", "w_entropy", "valid", "seq_batch_ids",
          "seq_end_pos", "seq_lens")
META = ("kv_ids", "kv_counts", "kv_types", "q_ids", "q_counts", "q_types")


def _numpy(monkeypatch, fn, *args, **kw):
    with monkeypatch.context() as m:
        m.setenv("DTA_NO_NATIVE", "1")
        return fn(*args, **kw)


def _trie(seed: int):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=int(rng.integers(1, 20)), vocab=50, max_len=40)
    return TokenTrie(seqs, attachs), JaxTokenTrie(seqs, attachs)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("seed", range(5))
def test_functions_equal_numpy_and_jax(monkeypatch, seed):
    """lcp_adjacent, flatten_core, endpoints_core, accumulate_up and
    seq_paths_core: bit-equal to the numpy path and to JAX's bridge."""
    trie, jtrie = _trie(seed)
    lcps = np.asarray(trie.lcp_lens, np.int64)
    _same(_native.lcp_adjacent(trie.inputs), lcp_arrays(trie.inputs).astype(np.int64), "lcp numpy")
    _same(_native.lcp_adjacent(trie.inputs), jax_native.lcp_adjacent(jtrie.inputs), "lcp jax")
    ref = _numpy(monkeypatch, flatten_trie, trie)
    core = _native.flatten_core(trie.inputs, lcps)
    for name, got, jax_got in zip(("tokens", "depth", "parent", "last_desc"), core,
                                  jax_native.flatten_core(jtrie.inputs, lcps)):
        _same(got, getattr(ref, name), name)
        _same(got, jax_got, name + " jax")
    q_leaf = np.asarray([i for i in range(trie.n_leaves) for _ in trie.attach_lists[i]], np.int64)
    q_len = np.asarray([length for i in range(trie.n_leaves) for _, length in trie.attach_lists[i]], np.int64)
    ends = _native.endpoints_core(trie.inputs, lcps, q_leaf, q_len)
    _same(ends.astype(np.int32), ref.seq_end_pos, "endpoints")
    _same(ends, jax_native.endpoints_core(jtrie.inputs, lcps, q_leaf, q_len), "endpoints jax")
    rng = np.random.default_rng(seed + 100)
    a0, b0 = rng.normal(size=(2, ref.n_padded))
    a, b, ja, jb, na, nb = a0.copy(), b0.copy(), a0.copy(), b0.copy(), a0.copy(), b0.copy()
    _native.accumulate_up(ref.parent, a, b)
    jax_native.accumulate_up(ref.parent, ja, jb)
    for j in range(ref.n_padded - 1, -1, -1):  # the numpy path's reverse sweep
        if ref.parent[j] >= 0:
            na[ref.parent[j]] += na[j]
            nb[ref.parent[j]] += nb[j]
    for got, want, what in ((a, na, "acc a"), (b, nb, "acc b"), (a, ja, "acc a jax"), (b, jb, "acc b jax")):
        _same(got, want, what)
    lmax = int(ref.seq_lens.max())
    paths = _native.seq_paths_core(ref.parent, ref.seq_end_pos.astype(np.int64), ref.seq_lens.astype(np.int64), lmax)
    _same(paths, _numpy(monkeypatch, ref.seq_paths_matrix), "paths")
    _same(paths, jax_native.seq_paths_core(ref.parent, ref.seq_end_pos.astype(np.int64),
                                           ref.seq_lens.astype(np.int64), lmax), "paths jax")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("bq,bk,min_kv,min_q", [(16, 16, 0, 0), (16, 32, 4, 0), (32, 16, 0, 3)])
def test_block_meta_core_equals_numpy_and_jax(monkeypatch, seed, bq, bk, min_kv, min_q):
    trie, _ = _trie(seed)
    p = _numpy(monkeypatch, flatten_trie, trie)
    ld = _pad_packed(p, -(-p.n_padded // 32) * 32).last_desc
    got = _native.block_meta_core(ld, bq, bk, min_kv, min_q)
    want = _numpy(monkeypatch, build_block_meta, ld, bq, bk, min_kv, min_q)
    for name, g, j in zip(META, got, jax_native.block_meta_core(ld, bq, bk, min_kv, min_q)):
        _same(g, getattr(want, name), name)
        _same(g, j, name + " jax")
    native_meta = build_block_meta(ld, bq, bk, min_kv, min_q)
    for name in META:
        _same(getattr(native_meta, name), getattr(want, name), name + " build_block_meta")


@pytest.mark.parametrize("seed", range(4))
def test_flatten_trie_through_the_bridge_equals_numpy(monkeypatch, seed):
    trie, _ = _trie(seed)
    a, b = flatten_trie(trie), _numpy(monkeypatch, flatten_trie, trie)
    for name in FIELDS:
        _same(getattr(a, name), getattr(b, name), name)
    _same(a.seq_paths_matrix(), _numpy(monkeypatch, b.seq_paths_matrix), "paths")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), **extra)
    env.pop("DTA_NO_NATIVE", None)
    return env


def test_import_builds_nothing(tmp_path):
    """Every module of the port imports in a process whose PATH holds no
    compiler, and the bridge has loaded nothing after it."""
    code = ("import importlib, pkgutil, dynamictreeattn_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "from dynamictreeattn_tpu_torch.tries import _native\n"
            "assert _native._LIB is None\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(PATH=str(tmp_path)), capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_concurrent_builds_leave_the_committed_library(tmp_path):
    """Two processes building into one empty directory at once both load
    the library; native/libtreekit.so keeps its bytes and mtime."""
    before = (COMMITTED.stat().st_mtime_ns, hashlib.sha256(COMMITTED.read_bytes()).hexdigest())
    code = ("import sys, numpy as np\n"
            "from pathlib import Path\n"
            "from dynamictreeattn_tpu_torch.tries import _native\n"
            "_native.BUILD_DIR = Path(sys.argv[1])\n"
            "print(_native.lcp_adjacent([np.array([1, 2, 3]), np.array([1, 2, 4])]).tolist())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build")], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.strip() == "[2]"
    assert [f.suffix for f in (tmp_path / "build").iterdir()] == [".so"]  # no temporary file left
    assert (COMMITTED.stat().st_mtime_ns, hashlib.sha256(COMMITTED.read_bytes()).hexdigest()) == before


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "treekit.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.delenv("DTA_NO_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="DTA_NO_NATIVE=1"):
        _native.native_enabled()
    assert not list((tmp_path / "build").iterdir())  # the failed output is removed
