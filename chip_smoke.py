#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (under /usr/local/cuda or on PATH); without a
card it exits non-zero and prints no result. Phases, each a hard failure:

1. build every CUDA source of the port (``dynamictreeattn_tpu_torch/csrc``)
   with nvcc for sm_90a, all at once;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes: the tree-attention forward, bound (K1) and online (K2), on
   layer 0's q/k/v of the trie below, through both branches of the bound
   dispatch; the tree-attention backward in its three modes — "cached" (K3),
   "fused" (K10) and "split" (dq K11, dk/dv K12) — on the same q/k/v with
   (o, lse) from K1 and from K2, plus a small input where a dropped kv tile
   or an unmasked partial tile would fail the check several times over, and
   the largest difference between two launches of the fused kernels (fp32
   atomics: not bit-reproducible); the LM-head statistics forward (K8) and backward (K9) on the
   trie's final hidden states, plus ragged rows, vocabularies and
   temperature; the qk-prep forward (K4 q, K5 k/v) and backward (K6 q, K7
   k/v) on layer 0's q/k/v projections, with seeded norm weights and
   cotangents, at the trie's length and a ragged one, and without the norm
   at Llama-3.2-3B and Qwen2.5-0.5B widths, plus three bugs planted in the
   plain version that the check must see;
3. drive the forward path — Qwen3-0.6B at full width (28 layers, d=1024,
   16/8 heads, V=151936, bf16, random weights from seed 0) through
   ``TreeEngine.prepare`` -> ``TreeEngine.forward`` on the 1-group rollout
   trie of bench.py and on its dense packing (plus one tree forward with the
   online softmax, the path that runs K2) — and check tree == dense
   log-probs, a reference on a small input, the fused qk-prep path against
   the unfused one (``fused_qk="off"``), and that every forward kernel
   launched exactly as often as 28 layers need;
4. drive the training path — ``TreeEngine.loss_and_grad`` (remat, the
   default backward "auto" = "cached" (K3) with the slot schedule that
   ``prepare`` builds, fused qk-prep) on the same tree and dense batches —
   and check that every forward/backward kernel of the path launched as
   often as 28 layers under remat need (and K10, K11, K12 never), that each
   layer's recompute took its forward's K1/K2 branch, tree == dense loss and
   per-parameter gradients, fused == unfused qk-prep, and a reference on a
   small input; then one tree step each with ``bwd_mode="split"`` and
   ``"fused"``, counted from 0 on its own, against the "cached" step;
5. time the host's ``prepare``, the forwards and the training steps (fused
   and unfused qk-prep; the three backward modes in turns), profile each by
   kernel class, and time each kernel beside its bound, its plain version
   and one library call as a yardstick.

The last three lines are the per-kernel JSON, the card's name and power
limit from nvidia-smi, and the JSON status line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE, MODEL = "cuda", "qwen3-0.6b"
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version, same inputs on the card:
# o is bf16 (spacing 2^-7 at |o| in [1, 2), 2^-6 in [2, 4)); the two sum in
# different orders, and the online kernel's 64-column running maxima differ
# from the plain loop's 128-column blocks, so P rounds to bf16 at other
# points: allow |diff| <= 1e-2 + 2e-2 * |ref|. lse is fp32 over sums of up to
# n terms: 1e-3.
ATTN_O_ATOL, ATTN_O_RTOL, ATTN_LSE_ATOL = 1e-2, 2e-2, 1e-3
# K8: fp32 (lse, mean_x) from 1024-deep bf16 products summed in another
# order, folded over 151936 columns. Measured on an H100: lse 1.9e-6,
# mean_x 2.4e-6, ragged V 5.1e-6; 1e-4 is ~20x that. With random weights
# the logits are near-uniform, so one dropped 128-column tile moves lse by
# ~8e-4 and 51 unmasked zero columns past V by ~3e-4: both fail at 1e-4.
LM_ATOL = 1e-4
# Tree vs dense per-token log-probs in bf16: the same tokens see the same
# ancestors, but the packings differ in length, so matmuls may take other
# algorithms and round differently through 28 bf16 layers. Bench-style
# scalar check: the summed log-prob agrees to 1e-3 relative; per token to
# 0.25 nats (a bf16 rounding of a logit near 16 is 0.06).
TREE_DENSE_SUM_RTOL, TREE_DENSE_TOKEN_ATOL = 1e-3, 0.25
# Kernel path vs the dense reference path (reference attention + plain
# vocab fold) on a small input, bf16: per token.
SMALL_REF_TOKEN_ATOL = 0.25
# K11/K12 vs plain, per element, relative to max|ref|: dq, dk, dv are bf16
# (spacing 2^-8 of the largest values, 0.39%); p and ds are rounded to bf16
# by the same formulas from scores summed in another order, so single
# roundings may flip by one ulp before the fp32 sums. Measured on an H100
# with random inputs at the main-path shapes: <= 0.53%. 2% leaves ~4x.
BWD_REL_TOL = 2e-2
# K9 vs plain, per element, relative to max|ref|: dh, dWT bf16 (0.39% at
# the top), dl rounded to bf16 from logits summed in another order.
# Measured on an H100 with random inputs: <= 0.60%.
LM_BWD_REL_TOL = 2e-2
# K4-K7 vs plain, per element: |diff| <= QK_RTOL*|ref| + QK_ATOL_REL*max|ref|.
# Both compute in fp32 and round once to bf16; their fp32 values differ by a
# few fp32 ulps (rsqrtf, the sum of squares in another order), which can
# flip a rounding by one bf16 ulp (at most 2^-7 of the value); elements that
# cancel to near zero keep the fp32 difference, far under 1e-5 of the
# largest value. Measured on an H100 at the main-path shapes: 0 elements
# past one ulp. dw is fp32, summed over n*H terms in another order:
# measured 6.3e-7 of max|ref|; 1e-5 leaves ~15x.
QK_RTOL, QK_ATOL_REL, QK_DW_REL = 2.0**-7, 1e-5, 1e-5
# a bug that a check exists to catch must move the result by at least this
# many tolerances on its adversarial input
ADVERSARIAL_MIN_RATIO = 3.0
# Training step, tree vs dense and kernel path vs reference path: the loss
# to the JAX bench's loss_rel bar; per-parameter gradient rel err
# ||g - g_ref|| / ||g_ref|| to the reference prototype's own committed bf16
# result, 1.0636e-1 (grad/Qwen3-0.6B-TB-vs-DB-bf16.txt).
STEP_LOSS_RTOL, STEP_GRAD_REL = 1e-3, 0.11
FWD_KERNELS = ("tree_attn_fwd_bound", "tree_attn_fwd_online", "lm_stats_fwd",
               "qk_prep_fwd_q", "qk_prep_fwd_kv")
TRAIN_KERNELS = ("tree_attn_fwd_bound", "tree_attn_bwd_cached", "lm_stats_fwd", "lm_stats_bwd",
                 "qk_prep_fwd_q", "qk_prep_fwd_kv", "qk_prep_bwd_q", "qk_prep_bwd_kv")
# backward mode -> the kernels that run it
BWD_KERNELS = {"cached": ("tree_attn_bwd_cached",), "fused": ("tree_attn_bwd_fused",),
               "split": ("tree_attn_bwd_dq", "tree_attn_bwd_dkv")}
QK_KERNELS = (("qk_prep_fwd_q", "K4", 84), ("qk_prep_fwd_kv", "K5", 96),
              ("qk_prep_bwd_q", "K6", 105), ("qk_prep_bwd_kv", "K7", 127))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device ms of fn() over `iters` launches, each with a cold L2
    (a 64 MB buffer is rewritten before each, outside the timed events).
    The device first spins for ~2e7 cycles per launch (~10 ms at the H100's
    clock), so the host queues every launch before the device reaches it: a
    kernel shorter than its wrapper's host time would otherwise be timed
    with the host's gap in it."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(int(2e7) * iters)
    for e0, e1 in pairs:
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in pairs) / iters


def turns_ms(*runs, rounds: int = 4):
    """([median ms of each run], [all times of each run]) on the host clock,
    each call synchronised, timed in turns after one warm-up each, the order
    reversed every other round (a b b a a b ... for two runs): versions
    compared in one call, so that drift of the host or the card falls on
    all of them."""
    for run in runs:
        run()
    times = [[] for _ in runs]
    order = list(range(len(runs)))
    for r in range(rounds):
        for which in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[which]()
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t) * 1e3)
    return [float(np.median(ts)) for ts in times], times


def check_close(name, got, ref, atol, rtol=0.0) -> float:
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside |diff| <= {atol} + {rtol}*|ref|, "
             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_rel(name, got, ref, rel) -> float:
    """Fail unless every |got - ref| <= rel * max|ref|; returns max|err|."""
    return check_close(name, got, ref, rel * float(ref.float().abs().max()))


def unmasked_pairs(last_desc: torch.Tensor, n: int) -> int:
    return int((last_desc.long() - torch.arange(n, device=last_desc.device) + 1).sum())


def attention_work(last_desc: torch.Tensor, hq: int, hkv: int, dh: int, n: int, bound: bool):
    """(flops, bytes) the tree-attention forward needs for these inputs:
    4*dh flops per unmasked (q, k) pair per q head; q/k/v read once, o and
    lse written once, plus the mask and metadata reads."""
    flops = 4.0 * dh * hq * unmasked_pairs(last_desc, n)
    nbytes = 2 * (hq + 2 * hkv + hq) * n * dh + 4 * hq * n + 4 * n
    if bound:
        nbytes += 4 * hq * n  # C
    return flops, nbytes


def attention_bwd_work(last_desc: torch.Tensor, hq: int, hkv: int, dh: int, n: int, kind: str):
    """(flops, bytes) of one backward kernel for these inputs: per unmasked
    (q, k) pair per q head, 3 matmuls for dq (s, dp, dq), 4 for dk/dv (s, dp,
    dv, dk) and 5 for the fused dq/dk/dv (s, dp, dq, dk, dv), 2*dh flops
    each; q, k, v, do, lse, di read once, the bf16 outputs written once, plus
    the mask reads."""
    n_mm, out_elems = {"dq": (3, hq * n * dh), "dkv": (4, 2 * hkv * n * dh),
                       "fused": (5, (hq + 2 * hkv) * n * dh)}[kind]
    flops = n_mm * 2.0 * dh * hq * unmasked_pairs(last_desc, n)
    nbytes = 2 * (2 * hq + 2 * hkv) * n * dh + 8 * hq * n + 4 * n + 2 * out_elems
    return flops, nbytes


def mutated_meta(meta, how: str):
    """The six metadata arrays with one planted bug (the slot schedule after
    them passed through): "drop" removes the first kv tile of the q block
    with the most slots (from both the query-major and the key-major view);
    "unmask" treats every partial tile as full."""
    kv_ids, kv_counts, kv_types, q_ids, q_counts, q_types = (t.clone() for t in meta[:6])
    if how == "drop":
        i = int(torch.argmax(kv_counts))
        j = int(kv_ids[i, 0])
        kv_types[i, 0] = 0
        t = int(torch.nonzero(q_ids[j, : int(q_counts[j])] == i)[0, 0])
        q_types[j, t] = 0
    else:
        kv_types[kv_types == 1] = 2
        q_types[q_types == 1] = 2
    return (kv_ids, kv_counts, kv_types, q_ids, q_counts, q_types, *meta[6:])


def attention_bwd(ta, mode, q4, k, v, ld, meta, do, lse, di, scale, bq, bkv, plain=False):
    """(dq, dk, dv) of backward mode `mode` ("cached", "fused", "split") from
    its kernels or, with `plain`, their plain versions; `meta` holds the six
    block arrays and the slot schedule (actions, flush)."""
    tail = (do, lse, di, scale, bq, bkv)
    sfx = "_plain" if plain else ""
    if mode == "split":
        return (getattr(ta, "tree_attn_bwd_dq" + sfx)(q4, k, v, ld, *meta[:3], *tail),
                *getattr(ta, "tree_attn_bwd_dkv" + sfx)(q4, k, v, ld, *meta[3:6], *tail))
    if mode == "fused":
        return getattr(ta, "tree_attn_bwd_fused" + sfx)(q4, k, v, ld, *meta[:3], *tail)
    if plain:
        return ta.tree_attn_bwd_cached_plain(q4, k, v, ld, *meta[:3], *meta[6:8], *tail)
    return ta.tree_attn_bwd_cached(q4, k, v, ld, *meta[:8], *tail)


def check_attention_bwd(ta, mode, label, q4, k, v, ld, meta, o, lse, do, scale, bq, bkv):
    """Backward mode `mode`'s kernels against their plain versions on the
    same inputs; returns ({"dq"|"dk"|"dv": max|err|}, (dq, dk, dv) of the
    plain versions, {"dq"|...: max |difference| between two kernel runs})."""
    di = torch.sum(do.float() * o.float(), dim=-1)
    args = (q4, k, v, ld, meta, do, lse, di, scale, bq, bkv)
    got, again = attention_bwd(ta, mode, *args), attention_bwd(ta, mode, *args)
    torch.cuda.synchronize()
    want = attention_bwd(ta, mode, *args, plain=True)
    names = ("dq", "dk", "dv")
    errs = {name: check_rel(f"{label} {name}", g_, w_, BWD_REL_TOL)
            for name, g_, w_ in zip(names, got, want)}
    repeat = {name: float((a_.float() - b_.float()).abs().max()) for name, a_, b_ in zip(names, got, again)}
    return errs, want, repeat


def qk_outputs(qp, q, k, v, qw, kw, cos, sin, eps, use_norm, gq, gk, gv, plain: bool):
    """{name: tensor} of the four qk-prep kernels (plain=False) or their plain
    versions on the same inputs: q, k, v of the forward, dq, dqw, dk, dv, dkw
    of the backward (dqw, dkw absent without the norm)."""
    f = (lambda name: getattr(qp, name + "_plain")) if plain else (lambda name: getattr(qp, name))
    out = {"q": f("qk_prep_fwd_q")(q, qw, cos, sin, eps, use_norm)}
    out["k"], out["v"] = f("qk_prep_fwd_kv")(k, v, kw, cos, sin, eps, use_norm)
    out["dq"], out["dqw"] = f("qk_prep_bwd_q")(gq, q, qw, cos, sin, eps, use_norm)
    out["dk"], out["dv"], out["dkw"] = f("qk_prep_bwd_kv")(gk, gv, k, kw, cos, sin, eps, use_norm)
    return {key: val for key, val in out.items() if val is not None}


def qk_tol(ref: torch.Tensor, name: str):
    """(atol, rtol) of the K4-K7 check for output `name`."""
    top = float(ref.float().abs().max())
    return (QK_DW_REL * top, 0.0) if name.endswith("w") else (QK_ATOL_REL * top, QK_RTOL)


def qk_tolerances(got: torch.Tensor, ref: torch.Tensor, name: str) -> float:
    """max over elements of |got - ref| / (atol + rtol*|ref|)."""
    atol, rtol = qk_tol(ref, name)
    return float(((got.float() - ref.float()).abs() / (atol + rtol * ref.float().abs())).max())


def qk_work(n: int, H: int, dh: int, kind: str) -> float:
    """Bytes one qk-prep kernel must move: bf16 activations read and written
    once, fp32 cos/sin read once, the bf16 norm weight (and the fp32 dw) —
    with the norm, as on the main path."""
    act = 2 * n * H * dh  # one [n, H*dh] bf16 tensor
    rope = 2 * 4 * n * dh
    n_act = {"fwd_q": 2, "fwd_kv": 4, "bwd_q": 3, "bwd_kv": 5}[kind]
    extra = 2 * dh + (4 * dh if kind.startswith("bwd") else 0)
    return n_act * act + rope + extra


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _kernel_layer(name: str) -> str:
    if "qk_prep" in name:
        return "qk-prep (K4-K7)"
    if "tree_attn_fwd" in name:
        return "tree attention fwd (K1/K2)"
    if "tree_attn_bwd" in name:
        return "tree attention bwd (K3 / K10 / K11+K12)"
    if "lm_stats" in name:
        return "LM-head stats fwd (K8)"
    if "lm_bwd_dlogits" in name or "gemm_bf16" in name:
        return "LM-head stats bwd (K9)"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmuls (cuBLAS)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies"
    return "elementwise / norms / rope / gathers"


def profile_run(run, label: str) -> dict:
    """One traced run: device time by layer, top kernels, and the device's
    idle share of the host-clock wall time. Returns {layer: device ms}
    (empty when no device event was traced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if not by_name:
        log(f"profile {label}: no device events traced; device time not measured")
        return {}
    layers: dict[str, float] = {}
    for name, ms in by_name.items():
        layers[_kernel_layer(name)] = layers.get(_kernel_layer(name), 0.0) + ms
    log(f"profile {label}: wall {wall_ms:.2f} ms (traced), device busy {busy:.2f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}")
    for layer, ms in sorted(layers.items(), key=lambda kv: -kv[1]):
        log(f"  layer {layer}: {ms:.2f} ms ({ms / busy:.3f} of busy)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  kernel {name[:90]}: {ms:.2f} ms")
    rest = [(name, ms) for name, ms in by_name.items()
            if _kernel_layer(name) == "elementwise / norms / rope / gathers"]
    for name, ms in sorted(rest, key=lambda kv: -kv[1])[:6]:
        log(f"  elementwise kernel {name[:90]}: {ms:.2f} ms")
    return layers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamictreeattn_tpu_torch.data import sharing_ratio, synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine, pack_sequences_dense
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.models.qwen3 import (
        attention_inputs, lm_head_weight, rms_norm, rope_tables,
    )
    from dynamictreeattn_tpu_torch.ops import _build
    import dynamictreeattn_tpu_torch.ops.qk_prep as qp
    import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module, not the function)
    ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
    from dynamictreeattn_tpu_torch.ops.lm_stats import (
        lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain,
    )
    from dynamictreeattn_tpu_torch.tries import TokenTrie, build_block_meta, build_bwd_cache_sched
    from dynamictreeattn_tpu_torch.utils import compare_grads

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: true fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 1. build
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(_build.KERNEL_SOURCES)}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    # ---- main-path setup: model, trie, batches
    mc = MODEL_CONFIGS[MODEL]
    params = init_params(mc, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    seqs, attachs = synthetic_rollout_batch(
        seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
        completion_len=(128, 512), branch_prob=0.85,
    )
    n_dense_tokens = sum(len(s) for s in seqs)
    ec = EngineConfig()
    engine = TreeEngine(mc, ec, device=dev)
    online_engine = TreeEngine(mc, dataclasses.replace(ec, fwd_softmax="online"), device=dev)
    unfused_engine = TreeEngine(mc, dataclasses.replace(ec, fused_qk="off"), device=dev)
    mode_engines = {mode: TreeEngine(mc, dataclasses.replace(ec, bwd_mode=mode), device=dev)
                    for mode in ("split", "fused")}
    trie = TokenTrie(seqs, attachs)
    dense_packed = pack_sequences_dense(seqs, attachs, pad_multiple=ec.pad_multiple)

    def host_ms(fn, iters=3):
        """(median host ms of fn() over `iters` calls, its last result)."""
        ts = []
        for _ in range(iters):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts)), out

    # the host trie layer: prepare (flatten, pad, block metadata, the slot
    # schedule of the default "cached" backward, upload), and its parts
    prep_tree_ms, tree_batch = host_ms(lambda: engine.prepare(trie))
    prep_dense_ms, dense_batch = host_ms(lambda: engine.prepare(dense_packed))
    prep_split_ms, _ = host_ms(lambda: mode_engines["split"].prepare(trie))
    n = tree_batch.n_padded
    sched_ms = {}
    for label, packed_ in (("tree", tree_batch.packed), ("dense", dense_batch.packed)):
        bm = build_block_meta(packed_.last_desc, ec.block_q, ec.block_kv)
        sched_ms[label], _ = host_ms(lambda: build_bwd_cache_sched(bm, bm.q_ids.shape[0]))
        sched_ms[label + " visits"] = int((bm.kv_types > 0).sum())
    log(f"workload: {len(seqs)} seqs, {n_dense_tokens} dense tokens, sharing "
        f"{sharing_ratio(seqs):.4f}, tree {tree_batch.packed.n_tokens} -> padded {n}, "
        f"dense padded {dense_batch.n_padded}, blocks {ec.block_q}/{ec.block_kv}")
    log(f"host prepare (median of 3, host clock): tree {prep_tree_ms:.2f} ms (from the TokenTrie: "
        f"flatten, pad, block metadata, slot schedule, upload), dense {prep_dense_ms:.2f} ms (from the "
        f"packed dense forest); tree without the schedule (bwd_mode=\"split\") {prep_split_ms:.2f} ms; "
        f"build_bwd_cache_sched alone: tree {sched_ms['tree']:.2f} ms over {sched_ms['tree visits']} "
        f"visits, dense {sched_ms['dense']:.2f} ms over {sched_ms['dense visits']} visits")
    if len(tree_batch.meta) != 8 or len(dense_batch.meta) != 8:
        fail("prepare built no slot schedule for the default (cached) backward")

    # ---- 2. kernels vs plain versions at the main path's shapes
    hq, hkv, dh = mc.num_attention_heads, mc.num_key_value_heads, mc.head_dim
    scale = dh**-0.5
    with torch.inference_mode():
        x = params["embed"].index_select(0, tree_batch.tokens.long())
        cos, sin = rope_tables(tree_batch.depth, dh, mc.rope_theta, mc.rope_scaling_tuple)
        lp0 = {name: w[0] for name, w in params["layers"].items()}
        q, k, v = attention_inputs(rms_norm(x, lp0["ln1"], mc.rms_norm_eps), lp0, cos, sin, mc)
        q4 = q.reshape(hkv, hq // hkv, n, dh).contiguous()
        k, v = k.contiguous(), v.contiguous()
        meta = tree_batch.meta
        ld = tree_batch.last_desc
        bq, bkv = ec.block_q, ec.block_kv
        c = ta._score_bound(q4, k, scale)
        c_max = float(c.max())
        if not c_max < ta.BOUND_SAFE_MAX:
            fail(f"layer-0 bound max(C)={c_max:.2f} should be < {ta.BOUND_SAFE_MAX} (qk-norm)")
        attn_args = (ld, *meta[:3], scale, bq, bkv)
        o1, lse1 = ta.tree_attn_fwd_bound(q4, k, v, *attn_args, c)
        o1p, lse1p = ta.tree_attn_fwd_plain(q4, k, v, *attn_args, c=c)
        o2, lse2 = ta.tree_attn_fwd_online(q4, k, v, *attn_args)
        o2p, lse2p = ta.tree_attn_fwd_plain(q4, k, v, *attn_args)
        torch.cuda.synchronize()
        errs = {
            "K1 o": check_close("K1 o", o1, o1p, ATTN_O_ATOL, ATTN_O_RTOL),
            "K1 lse": check_close("K1 lse", lse1, lse1p, ATTN_LSE_ATOL),
            "K2 o": check_close("K2 o", o2, o2p, ATTN_O_ATOL, ATTN_O_RTOL),
            "K2 lse": check_close("K2 lse", lse2, lse2p, ATTN_LSE_ATOL),
            "K1 vs K2 o": check_close("K1 vs K2 o", o1, o2, ATTN_O_ATOL, ATTN_O_RTOL),
        }
        log(f"K1/K2 at q4 {tuple(q4.shape)}, slots {meta[0].shape[1]}, max C {c_max:.3f}: "
            + ", ".join(f"{key} max|err| {val:.3e}" for key, val in errs.items())
            + f" (o tol {ATTN_O_ATOL}+{ATTN_O_RTOL}*|ref|: bf16 output spacing, other summation "
              f"order and P rounding points; lse tol {ATTN_LSE_ATOL}: fp32 sums)")
        # both branches of the bound dispatch: the real inputs take K1; q
        # scaled by a power of two (exact in bf16) that pushes max(C) past 40
        # must take K2
        big = 2.0 ** math.ceil(math.log2(ta.BOUND_SAFE_MAX / c_max))
        for label, qq, want in (("max(C) < 40", q4, "tree_attn_fwd_bound"),
                                (f"q*{big:g}, max(C) >= 40", q4 * big, "tree_attn_fwd_online")):
            _build.reset_launches()
            od, lsed = ta._fwd_dispatch(qq, k, v, ld, *meta[:3], scale, ta.BlockSizes(bq, bkv), "bound")
            moved = [key for key, val in _build.LAUNCHES.items() if val]
            if moved != [want]:
                fail(f"dispatch with {label} launched {moved}, expected [{want}]")
            op, lsep = ta.tree_attn_fwd_plain(qq, k, v, *attn_args)
            e_o = check_close(f"dispatch {label} o", od, op, ATTN_O_ATOL, ATTN_O_RTOL)
            e_l = check_close(f"dispatch {label} lse", lsed, lsep, ATTN_LSE_ATOL)
            log(f"dispatch {label}: took {want}, o max|err| {e_o:.3e}, lse max|err| {e_l:.3e}")

        # the three backward modes on the same q/k/v, with a seeded output
        # cotangent, (o, lse) from K1 and from K2; the slot schedule is the
        # one prepare built (R = every kv block: no eviction)
        gen = torch.Generator(device=dev).manual_seed(1)
        do = torch.randn(q4.shape, generator=gen, device=dev).to(torch.bfloat16)
        mode_ids = {"cached": "K3", "fused": "K10", "split": "K11/K12"}
        bwd_errs = {mode: {} for mode in BWD_KERNELS}  # mode -> {dq|dk|dv: max|err|}
        bwd_repeat = {}
        for mode, kid in mode_ids.items():
            for label, o_, lse_ in ((f"{kid} with K1's lse", o1, lse1), (f"{kid} with K2's lse", o2, lse2)):
                errs_b, _, rep = check_attention_bwd(ta, mode, label, q4, k, v, ld, meta, o_, lse_, do,
                                                     scale, bq, bkv)
                for key, val in errs_b.items():
                    bwd_errs[mode][key] = max(bwd_errs[mode].get(key, 0.0), val)
                for key, val in rep.items():
                    bwd_repeat[mode, key] = max(bwd_repeat.get((mode, key), 0.0), val)
                log(f"{label} at q4 {tuple(q4.shape)}, slots {meta[0].shape[1]}/{meta[3].shape[1]}"
                    f"{', schedule R ' + str(meta[7].shape[0]) if mode == 'cached' else ''}: "
                    + ", ".join(f"{key} max|err| {val:.3e}" for key, val in errs_b.items())
                    + f" (tol {BWD_REL_TOL}*max|ref|: bf16 outputs, p and ds rounded to bf16 "
                      "from scores summed in another order); two launches differ by max |d| "
                    + "/".join(f"{val:.3e}" for val in rep.values()))
        log("run to run (fused kernels sum with fp32 atomics, so not bit-reproducible; no bar): "
            + ", ".join(f"{mode_ids[m]} {key} {val:.3e}" for (m, key), val in bwd_repeat.items()))
        if any(bwd_repeat[mode, key] for mode in ("split",) for key in ("dq", "dk", "dv")):
            fail("K11/K12 (no atomics) differ between two launches on the same inputs")

        # adversarial: a small dense packing (4 chains of 192 tokens), where
        # each row sees at most 3 key sub-tiles; a kernel that dropped a kv
        # tile or skipped the mask of a partial tile must fail by far
        adv_batch = engine.prepare(pack_sequences_dense([s_[:192] for s_ in seqs[:4]], attachs[:4],
                                                        pad_multiple=ec.pad_multiple))
        na = adv_batch.n_padded
        xa = params["embed"].index_select(0, adv_batch.tokens.long())
        cos_a, sin_a = rope_tables(adv_batch.depth, dh, mc.rope_theta, mc.rope_scaling_tuple)
        qa, ka, va = attention_inputs(rms_norm(xa, lp0["ln1"], mc.rms_norm_eps), lp0, cos_a, sin_a, mc)
        qa4 = qa.reshape(hkv, hq // hkv, na, dh).contiguous()
        ka, va = ka.contiguous(), va.contiguous()
        oa, lsea = ta.tree_attn_fwd_bound(qa4, ka, va, adv_batch.last_desc, *adv_batch.meta[:3], scale,
                                          bq, bkv, ta._score_bound(qa4, ka, scale))
        doa = torch.randn(qa4.shape, generator=gen, device=dev).to(torch.bfloat16)
        dia = torch.sum(doa.float() * oa.float(), dim=-1)
        for mode, kid in mode_ids.items():
            errs_a, refs_a, _ = check_attention_bwd(ta, mode, f"{kid} adversarial", qa4, ka, va,
                                                    adv_batch.last_desc, adv_batch.meta, oa, lsea, doa,
                                                    scale, bq, bkv)
            for key, val in errs_a.items():
                bwd_errs[mode][key] = max(bwd_errs[mode][key], val)
            for how in ("drop", "unmask"):
                got = attention_bwd(ta, mode, qa4, ka, va, adv_batch.last_desc,
                                    mutated_meta(adv_batch.meta, how), doa, lsea, dia, scale, bq, bkv,
                                    plain=True)
                ratio = {name: float((g_ - r_).float().abs().max())
                         / (BWD_REL_TOL * float(r_.float().abs().max()))
                         for name, g_, r_ in zip(("dq", "dk", "dv"), got, refs_a)}
                log(f"{kid} adversarial n={na}: the '{how}' bug moves dq/dk/dv by "
                    + "/".join(f"{ratio[key]:.1f}" for key in ("dq", "dk", "dv"))
                    + f" tolerances (kernel max|err| "
                    + "/".join(f"{errs_a[key]:.3e}" for key in ("dq", "dk", "dv")) + ")")
                if not (ratio["dq"] >= ADVERSARIAL_MIN_RATIO
                        and max(ratio["dk"], ratio["dv"]) >= ADVERSARIAL_MIN_RATIO):
                    fail(f"the adversarial input does not expose the '{how}' bug in {kid}: {ratio}")

        # K4-K7 on layer 0's q/k/v projections of the trie (Qwen3: qk-norm),
        # with seeded norm weights (init_params' are ones, which would hide a
        # dropped weight) and seeded cotangents; then a ragged length and,
        # without the norm, the head layouts of Llama-3.2-3B (24/8, dh 128)
        # and Qwen2.5-0.5B (14/2, dh 64) on random inputs
        eps = mc.rms_norm_eps
        h0 = rms_norm(x, lp0["ln1"], eps)
        proj = [h0 @ lp0[name] for name in ("wq", "wk", "wv")]
        wq_r, wk_r = ((1 + 0.1 * torch.randn(dh, generator=gen, device=dev)).to(torch.bfloat16)
                      for _ in range(2))
        qk_errs: dict[str, float] = {}
        qk_main = None
        nr = n - 50
        mcs = {"llama-3.2-3b": MODEL_CONFIGS["llama-3.2-3b"], "qwen2.5-0.5b": MODEL_CONFIGS["qwen2.5-0.5b"]}
        # (label, (q, k, v), (qw, kw), cos, sin, use_norm, plant bugs)
        qk_cases = [(f"Qwen3-0.6B layer 0, n={n}", proj, (lp0["q_norm"], lp0["k_norm"]), cos, sin, True,
                     False),
                    (f"Qwen3-0.6B layer 0, seeded norm weights, n={n}", proj, (wq_r, wk_r), cos, sin, True,
                     True),
                    (f"Qwen3-0.6B layer 0, ragged n={nr}", [p_[:nr].contiguous() for p_ in proj],
                     (lp0["q_norm"], lp0["k_norm"]), cos[:nr].contiguous(), sin[:nr].contiguous(), True,
                     False)]
        for cname, cfg_ in mcs.items():
            hq_, hkv_, dh_ = cfg_.num_attention_heads, cfg_.num_key_value_heads, cfg_.head_dim
            cos_, sin_ = rope_tables(tree_batch.depth[:nr], dh_, cfg_.rope_theta, cfg_.rope_scaling_tuple)
            rnd = [torch.randn((nr, h_ * dh_), generator=gen, device=dev).to(torch.bfloat16)
                   for h_ in (hq_, hkv_, hkv_)]
            ones = torch.ones(dh_, dtype=torch.bfloat16, device=dev)
            qk_cases.append((f"{cname} heads {hq_}/{hkv_} dh {dh_}, no norm, random, n={nr}", rnd,
                             (ones, ones), cos_, sin_, False, False))
        for label, (q_, k_, v_), (qw_, kw_), cos_, sin_, use_norm, plant in qk_cases:
            nn_, dh_ = q_.shape[0], cos_.shape[-1]
            cts = [torch.randn((t.shape[1] // dh_, nn_, dh_), generator=gen, device=dev).to(torch.bfloat16)
                   for t in (q_, k_, v_)]
            args = (q_, k_, v_, qw_, kw_, cos_, sin_, eps, use_norm, *cts)
            got = qk_outputs(qp, *args, plain=False)
            again = qk_outputs(qp, *args, plain=False)
            torch.cuda.synchronize()
            if any(not torch.equal(got[key], again[key]) for key in got):
                fail(f"K4-K7 {label}: two runs on the same inputs differ (dw must sum in a fixed order)")
            want = qk_outputs(qp, *args, plain=True)
            errs_qk = {}
            for key, ref in want.items():
                atol_, rtol_ = qk_tol(ref, key)
                errs_qk[key] = check_close(f"K4-K7 {label} {key}", got[key], ref, atol_, rtol_)
                qk_errs[key] = max(qk_errs.get(key, 0.0), errs_qk[key])
            log(f"K4-K7 {label} (two runs bit-equal): "
                + ", ".join(f"{key} max|err| {val:.3e}" for key, val in errs_qk.items())
                + f" (tol {QK_RTOL:.4g}*|ref| + {QK_ATOL_REL}*max|ref|: one bf16 rounding of fp32 values "
                  f"a few fp32 ulps apart; dw {QK_DW_REL}*max|ref|: fp32 sums in another order)")
            if qk_main is None:
                qk_main = args
            if plant:
                # bugs planted in the plain version: each must move q, k, dq
                # and dk by ADVERSARIAL_MIN_RATIO tolerances or more; for
                # the head offset, head h takes head h-1's inputs
                rolled = [t.reshape(nn_, -1, dh_).roll(1, 1).reshape(t.shape) for t in (q_, k_, v_)]
                bugs = {
                    "sin sign flipped": (q_, k_, v_, qw_, kw_, cos_, -sin_, eps, use_norm, *cts),
                    "head offset by one": (*rolled, qw_, kw_, cos_, sin_, eps, use_norm,
                                           *(c_.roll(1, 0) for c_ in cts)),
                    "norm weight dropped": (q_, k_, v_, torch.ones_like(qw_), torch.ones_like(kw_), cos_, sin_,
                                            eps, use_norm, *cts),
                }
                for how, bad_args in bugs.items():
                    bad = qk_outputs(qp, *bad_args, plain=True)
                    ratio = {key: qk_tolerances(bad[key], want[key], key) for key in ("q", "k", "dq", "dk")}
                    log(f"K4-K7 adversarial: the '{how}' bug moves q/k/dq/dk by "
                        + "/".join(f"{val:.1f}" for val in ratio.values()) + " tolerances")
                    if min(ratio.values()) < ADVERSARIAL_MIN_RATIO:
                        fail(f"the K4-K7 check does not expose the '{how}' bug: {ratio}")
        del proj

        hidden = engine.hidden(params, tree_batch)
        w_lm = lm_head_weight(params, mc)
        lse8, mx8 = lm_stats(hidden, w_lm)
        lse8p, mx8p = lm_stats_plain(hidden, w_lm)
        torch.cuda.synchronize()
        e_lse8 = check_close("K8 lse", lse8, lse8p, LM_ATOL)
        e_mx8 = check_close("K8 mean_x", mx8, mx8p, LM_ATOL)
        log(f"K8 at hidden {tuple(hidden.shape)} x W {tuple(w_lm.shape)}: lse max|err| "
            f"{e_lse8:.3e}, mean_x max|err| {e_mx8:.3e} (tol {LM_ATOL}: fp32 statistics of "
            f"1024-deep bf16 products summed in another order)")
        # ragged edges: rows not a multiple of 128, a vocab not a multiple of
        # 128, temperature != 1; at V=179 (one full tile + 51 columns) the 77
        # columns past V, left unmasked, would move lse by ~0.3
        hr = hidden[: n - 50]
        for vr in (w_lm.shape[1] - 77, 179):
            wr = w_lm[:, :vr]
            for got, want, what in zip(lm_stats(hr, wr, 1 / 0.7), lm_stats_plain(hr, wr, 1 / 0.7),
                                       ("lse", "mean_x")):
                e_r = check_close(f"K8 ragged V={vr} {what}", got, want, LM_ATOL)
                log(f"K8 ragged n={hr.shape[0]} V={vr} T=0.7 {what}: max|err| {e_r:.3e}")
        # a head passed as a contiguous [d, V] tensor, copied by the wrapper
        wu = w_lm[:, :32768].contiguous()
        for got, want, what in zip(lm_stats(hidden, wu), lm_stats_plain(hidden, wu),
                                   ("lse", "mean_x")):
            e_u = check_close(f"K8 contiguous head {what}", got, want, LM_ATOL)
            log(f"K8 contiguous [d, V] head V={wu.shape[1]} {what}: max|err| {e_u:.3e}")

        # K9 at the trie's final hidden states, seeded cotangents of (lse,
        # entropy); then ragged rows / vocabularies at T=0.7 (at V=179 the
        # masked tail is 77 columns of one 128-column tile)
        g_lse = torch.randn(n, generator=gen, device=dev)
        g_ent = torch.randn(n, generator=gen, device=dev)
        k9_err = 0.0
        for label, hh, ww, lse_, mx_, gl, ge, it in (
            (f"n={n} V={w_lm.shape[1]}", hidden, w_lm, lse8, mx8, g_lse, g_ent, 1.0),
            *((f"ragged n={hr.shape[0]} V={vr} T=0.7", hr, w_lm[:, :vr],
               *lm_stats(hr, w_lm[:, :vr], 1 / 0.7), g_lse[: n - 50], g_ent[: n - 50], 1 / 0.7)
              for vr in (w_lm.shape[1] - 77, 179)),
        ):
            got = lm_stats_bwd(hh, ww, lse_, mx_, gl, ge, it)
            torch.cuda.synchronize()
            want = lm_stats_bwd_plain(hh, ww, lse_, mx_, gl, ge, it)
            e_dh = check_rel(f"K9 {label} dh", got[0], want[0], LM_BWD_REL_TOL)
            e_dw = check_rel(f"K9 {label} dWT", got[1], want[1], LM_BWD_REL_TOL)
            k9_err = max(k9_err, e_dh, e_dw)
            log(f"K9 {label}: dh max|err| {e_dh:.3e} (max|ref| {float(want[0].abs().max()):.3e}), "
                f"dWT max|err| {e_dw:.3e} (max|ref| {float(want[1].abs().max()):.3e}) (tol "
                f"{LM_BWD_REL_TOL}*max|ref|: bf16 outputs, dl rounded to bf16 from logits summed "
                "in another order)")

    # ---- 3. forward path: counts from 0, drive, read
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    lp_tree = engine.forward(params, tree_batch)
    lp_dense = engine.forward(params, dense_batch)
    lp_online = online_engine.forward(params, tree_batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path launches: {launches}")
    missing = [key for key in FWD_KERNELS if launches[key] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    L = mc.num_hidden_layers
    qk_fwd = {key: launches[key] for key in ("qk_prep_fwd_q", "qk_prep_fwd_kv", "qk_prep_bwd_q",
                                             "qk_prep_bwd_kv")}
    if qk_fwd != {"qk_prep_fwd_q": 3 * L, "qk_prep_fwd_kv": 3 * L, "qk_prep_bwd_q": 0, "qk_prep_bwd_kv": 0}:
        fail(f"forward path qk-prep launches {qk_fwd}, expected {L} K4 and {L} K5 per forward, 3 forwards")

    if set(lp_tree) != set(range(len(seqs))) or set(lp_dense) != set(lp_tree):
        fail("per-sequence ids differ between tree and dense")
    worst_tok, sum_t, sum_d, worst_online = 0.0, 0.0, 0.0, 0.0
    for bid, seq in enumerate(seqs):
        a, b, o = lp_tree[bid], lp_dense[bid], lp_online[bid]
        if a.shape != (len(seq) - 1,) or not np.isfinite(a).all() or not np.isfinite(b).all():
            fail(f"seq {bid}: bad log-prob vector shape {a.shape} / finiteness")
        worst_tok = max(worst_tok, float(np.abs(a - b).max()))
        worst_online = max(worst_online, float(np.abs(a - o).max()))
        sum_t += float(a.astype(np.float64).sum())
        sum_d += float(b.astype(np.float64).sum())
    sum_rel = abs(sum_t - sum_d) / abs(sum_d)
    log(f"tree vs dense: summed log-prob {sum_t:.4f} vs {sum_d:.4f} (rel {sum_rel:.3e}, tol "
        f"{TREE_DENSE_SUM_RTOL}, the JAX bench's loss bar); per-token max|diff| {worst_tok:.4f} "
        f"(tol {TREE_DENSE_TOKEN_ATOL}: bf16 through 28 layers, packings of other lengths); "
        f"bound vs online engine per-token max|diff| {worst_online:.4f}")
    if sum_rel > TREE_DENSE_SUM_RTOL or worst_tok > TREE_DENSE_TOKEN_ATOL:
        fail("tree and dense log-probs disagree")
    if worst_online > TREE_DENSE_TOKEN_ATOL:
        fail("bound and online engines disagree")

    # the fused qk-prep path against the unfused one on the tree batch (the
    # unfused chain rounds the normed q/k to bf16 before RoPE: <= 1 ulp)
    lp_unfused = unfused_engine.forward(params, tree_batch)
    worst_fu, sum_u = 0.0, 0.0
    for bid in lp_tree:
        worst_fu = max(worst_fu, float(np.abs(lp_tree[bid] - lp_unfused[bid]).max()))
        sum_u += float(lp_unfused[bid].astype(np.float64).sum())
    fu_rel = abs(sum_t - sum_u) / abs(sum_u)
    log(f"fused vs unfused qk-prep, tree forward: summed log-prob {sum_t:.4f} vs {sum_u:.4f} (rel "
        f"{fu_rel:.3e}, tol {TREE_DENSE_SUM_RTOL}); per-token max|diff| {worst_fu:.4f} (tol "
        f"{TREE_DENSE_TOKEN_ATOL})")
    if fu_rel > TREE_DENSE_SUM_RTOL or worst_fu > TREE_DENSE_TOKEN_ATOL:
        fail("fused and unfused qk-prep forwards disagree")
    del lp_unfused

    # a reference on a small input: 4 sequences cut to 192 tokens, kernel
    # path vs dense-mask reference attention + plain vocab fold
    small = [s[:192] for s in seqs[:4]]
    ref_engine = TreeEngine(mc, dataclasses.replace(ec, attn_backend="reference", loss_mode="vocab"),
                            device=dev)
    small_trie = TokenTrie(small, attachs[:4])
    lp_k = engine.forward(params, engine.prepare(small_trie))
    lp_r = ref_engine.forward(params, ref_engine.prepare(small_trie))
    worst_small = max(float(np.abs(lp_k[i] - lp_r[i]).max()) for i in lp_k)
    log(f"small input vs reference path: per-token max|diff| {worst_small:.4f} "
        f"(tol {SMALL_REF_TOKEN_ATOL}: bf16 through 28 layers, other attention arithmetic)")
    if worst_small > SMALL_REF_TOKEN_ATOL:
        fail("kernel path disagrees with the reference path on a small input")

    # ---- 4. training path: counts from 0, drive, read; which forward kernel
    # each tree-attention call took, in call order
    branches: list[list[str]] = []
    real_dispatch = ta._fwd_dispatch

    def traced_dispatch(*args, **kwargs):
        before = dict(_build.LAUNCHES)
        out = real_dispatch(*args, **kwargs)
        branches.append([key for key, val in _build.LAUNCHES.items() if val != before[key]])
        return out

    del lp_tree, lp_dense, lp_online
    ta._fwd_dispatch = traced_dispatch
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_tree = engine.loss_and_grad(params, tree_batch)
    torch.cuda.synchronize()
    tree_counts, tree_branches = dict(_build.LAUNCHES), list(branches)
    step_dense = engine.loss_and_grad(params, dense_batch)
    torch.cuda.synchronize()
    ta._fwd_dispatch = real_dispatch
    train_launches = dict(_build.LAUNCHES)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"training path launches (tree step + dense step): {train_launches}; tree step alone: "
        f"{tree_counts}")
    missing = [key for key in TRAIN_KERNELS if train_launches[key] == 0]
    if missing:
        fail(f"kernels never launched on the training path: {missing}")
    def step_counts(bwd_mode: str) -> dict:
        """Launches one training step needs under remat with backward mode
        `bwd_mode`: forward + recompute, one backward of its kernels only."""
        return {"fwd": 2 * L, **{key: L if mode == bwd_mode else 0
                                 for mode, keys in BWD_KERNELS.items() for key in keys},
                "lm_stats_fwd": 1, "lm_stats_bwd": 1, "qk_prep_fwd_q": 2 * L, "qk_prep_fwd_kv": 2 * L,
                "qk_prep_bwd_q": L, "qk_prep_bwd_kv": L}

    def counted(counts: dict, like: dict) -> dict:
        return {"fwd": counts["tree_attn_fwd_bound"] + counts["tree_attn_fwd_online"],
                **{key: counts[key] for key in like if key != "fwd"}}

    per_step = step_counts("cached")
    for label, counts, steps in (("tree step", tree_counts, 1), ("both steps", train_launches, 2)):
        got = counted(counts, per_step)
        if got != {key: steps * val for key, val in per_step.items()}:
            fail(f"{label}: launch counts {got}, expected {steps} x {per_step} (28 layers under remat: "
                 "forward + recompute, one backward, K3 only)")
    if len(tree_branches) != 2 * L or tree_branches[L:] != tree_branches[:L][::-1]:
        fail(f"the remat recompute did not take each layer's forward branch: {tree_branches}")
    log(f"remat: each of the {L} recomputed layers took its forward's branch "
        f"({sum(b == ['tree_attn_fwd_bound'] for b in tree_branches[:L])} bound, "
        f"{sum(b == ['tree_attn_fwd_online'] for b in tree_branches[:L])} online in the tree step)")

    def check_step(label, got, ref):
        """Loss rel and per-parameter grad rel err of step `got` against
        step `ref`; fails past the bars."""
        (loss_g, grads_g, _), (loss_r, grads_r, _) = got, ref
        if not (math.isfinite(float(loss_g)) and math.isfinite(float(loss_r))):
            fail(f"{label}: non-finite loss")
        loss_rel = abs(float(loss_g) - float(loss_r)) / abs(float(loss_r))
        rows = compare_grads(grads_r, grads_g)
        rels = [r[1] for r in rows]
        log(f"{label}: loss {float(loss_g):.6f} vs {float(loss_r):.6f} (rel {loss_rel:.3e}, tol "
            f"{STEP_LOSS_RTOL}); {len(rows)} params, grad rel err max {rels[0]:.4e}, median "
            f"{float(np.median(rels)):.4e} (tol {STEP_GRAD_REL}: the reference prototype's bf16 "
            "tree-vs-dense result); worst 5: "
            + ", ".join(f"{name} {rel:.3e}" for name, rel, _ in rows[:5]))
        if not all(math.isfinite(r) for r in rels):
            fail(f"{label}: non-finite gradients")
        if loss_rel > STEP_LOSS_RTOL or rels[0] > STEP_GRAD_REL:
            fail(f"{label}: outside the bars")

    check_step("training tree vs dense", step_tree, step_dense)
    del step_dense
    check_step("training tree, fused vs unfused qk-prep", step_tree,
               unfused_engine.loss_and_grad(params, tree_batch))
    # the other two backward modes, each a drive of its own: counts from 0,
    # one tree step, read; held against the default ("cached") step
    mode_launches = {}
    for mode in ("split", "fused"):
        _build.reset_launches()
        step_m = mode_engines[mode].loss_and_grad(params, tree_batch)
        torch.cuda.synchronize()
        mode_launches[mode] = dict(_build.LAUNCHES)
        want = step_counts(mode)
        got = counted(mode_launches[mode], want)
        log(f"training tree step, bwd_mode=\"{mode}\": launches {got}")
        if got != want:
            fail(f"bwd_mode={mode!r} step: launch counts {got}, expected {want}")
        check_step(f"training tree, bwd_mode=\"{mode}\" vs \"cached\"", step_m, step_tree)
        del step_m
    del step_tree
    small_k = engine.loss_and_grad(params, engine.prepare(small_trie))
    small_r = ref_engine.loss_and_grad(params, ref_engine.prepare(small_trie))
    check_step("training small input, kernel path vs reference path", small_k, small_r)
    del small_k, small_r

    # ---- 5. timings
    def fwd_ms(eng, batch, iters=3):
        eng.forward(params, batch)
        ts = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.forward(params, batch)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts))

    tree_ms, dense_ms = fwd_ms(engine, tree_batch), fwd_ms(engine, dense_batch)
    online_ms = fwd_ms(online_engine, tree_batch)
    (fused_t, unfused_t), fwd_turns = turns_ms(lambda: engine.forward(params, tree_batch),
                                               lambda: unfused_engine.forward(params, tree_batch))
    log(f"forward: tree {tree_ms:.2f} ms, dense {dense_ms:.2f} ms (median of 3 after warm-up), "
        f"dense-equivalent tokens/s tree {n_dense_tokens / tree_ms * 1e3:.1f}, dense "
        f"{n_dense_tokens / dense_ms * 1e3:.1f}, speedup {dense_ms / tree_ms:.3f}; "
        f"max_memory_allocated {peak_gib:.3f} GiB; padded trie length {n}; tree with the "
        f"online softmax (no per-layer host read of max(C)) {online_ms:.2f} ms")
    log(f"forward, fused vs unfused qk-prep (fused_qk=\"off\"), tree, in turns: {fused_t:.2f} ms vs "
        f"{unfused_t:.2f} ms (medians of 4; fused " + " ".join(f"{t:.2f}" for t in fwd_turns[0])
        + ", unfused " + " ".join(f"{t:.2f}" for t in fwd_turns[1]) + ")")
    profile_run(lambda: engine.forward(params, tree_batch), "tree forward")
    profile_run(lambda: unfused_engine.forward(params, tree_batch), "tree forward, unfused qk-prep")
    profile_run(lambda: engine.forward(params, dense_batch), "dense forward")

    def step_ms(batch, iters=3):
        engine.loss_and_grad(params, batch)
        ts = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.loss_and_grad(params, batch)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts))

    tree_step, dense_step = step_ms(tree_batch), step_ms(dense_batch)
    log(f"training step: tree {tree_step:.2f} ms, dense {dense_step:.2f} ms (median of 3 after "
        f"warm-up), dense-equivalent trained tokens/s tree {n_dense_tokens / tree_step * 1e3:.1f}, "
        f"dense {n_dense_tokens / dense_step * 1e3:.1f}, speedup {dense_step / tree_step:.3f}; "
        f"max_memory_allocated over the tree + dense steps {train_peak_gib:.3f} GiB")
    (fused_t, unfused_t), step_turns = turns_ms(lambda: engine.loss_and_grad(params, tree_batch),
                                                lambda: unfused_engine.loss_and_grad(params, tree_batch))
    log(f"training step, fused vs unfused qk-prep (fused_qk=\"off\"), tree, in turns: {fused_t:.2f} ms "
        f"vs {unfused_t:.2f} ms (medians of 4; fused " + " ".join(f"{t:.2f}" for t in step_turns[0])
        + ", unfused " + " ".join(f"{t:.2f}" for t in step_turns[1]) + ")")
    step_engines = {"cached": engine, **mode_engines}
    mode_t, mode_turns = turns_ms(*(lambda e=e: e.loss_and_grad(params, tree_batch)
                                    for e in step_engines.values()))
    log("training step by backward mode, tree, in turns: "
        + ", ".join(f"{mode} {t:.2f} ms" for mode, t in zip(step_engines, mode_t))
        + " (medians of 4; " + "; ".join(f"{mode} " + " ".join(f"{t:.2f}" for t in ts)
                                         for mode, ts in zip(step_engines, mode_turns)) + ")")
    attn_bwd_class = {}
    for mode, eng in step_engines.items():
        layers_ = profile_run(lambda e=eng: e.loss_and_grad(params, tree_batch),
                              f"tree training step, bwd_mode=\"{mode}\"")
        attn_bwd_class[mode] = layers_.get(_kernel_layer("tree_attn_bwd"))
    log("profile: attention-backward class of the tree step, device ms: "
        + ", ".join(f"{mode} ({mode_ids[mode]}) " + ("not measured" if ms is None else f"{ms:.2f}")
                    for mode, ms in attn_bwd_class.items()))
    profile_run(lambda: unfused_engine.loss_and_grad(params, tree_batch),
                "tree training step, unfused qk-prep")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernels = []
    with torch.inference_mode():
        mask = (torch.arange(n, device=dev)[None, :] <= torch.arange(n, device=dev)[:, None]) \
            & (torch.arange(n, device=dev)[:, None] <= ld.long()[None, :])
        qs = q4.reshape(1, hq, n, dh)
        ks = k.repeat_interleave(hq // hkv, dim=0)[None]
        vs = v.repeat_interleave(hq // hkv, dim=0)[None]
        sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale), 10, flush)
        for name, kid, line, bound_c, err in (
            ("tree_attn_fwd_bound", "K1", 248, c, max(errs["K1 o"], errs["K1 lse"])),
            ("tree_attn_fwd_online", "K2", 80, None, max(errs["K2 o"], errs["K2 lse"])),
        ):
            if bound_c is not None:
                run = lambda: ta.tree_attn_fwd_bound(q4, k, v, *attn_args, bound_c)  # noqa: E731
                plain = lambda: ta.tree_attn_fwd_plain(q4, k, v, *attn_args, c=bound_c)  # noqa: E731
            else:
                run = lambda: ta.tree_attn_fwd_online(q4, k, v, *attn_args)  # noqa: E731
                plain = lambda: ta.tree_attn_fwd_plain(q4, k, v, *attn_args)  # noqa: E731
            flops, nbytes = attention_work(ld, hq, hkv, dh, n, bound_c is not None)
            b_ms, b_by = bound_ms(flops, nbytes)
            kernels.append({
                "name": name, "id": kid, "route": "cuda",
                "source": "dynamictreeattn_tpu_torch/csrc/tree_attn_fwd.cu",
                "replaces": f"dynamictreeattn_tpu/ops/tree_attention.py:{line}",
                "launches": launches[name], "max_abs_err": err,
                "ms": cuda_ms(run, 20, flush), "plain_ms": cuda_ms(plain, 2, flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": sdpa_ms,
                "library_call": "SDPA forward, dense bool mask",
            })

        def lib_lm():
            parts = [torch.logsumexp(torch.matmul(hidden, w_lm[:, c0:c0 + 16384]).float(), dim=-1)
                     for c0 in range(0, w_lm.shape[1], 16384)]
            return torch.logsumexp(torch.stack(parts), dim=0)

        V = w_lm.shape[1]
        b_ms, b_by = bound_ms(2.0 * n * mc.hidden_size * V,
                              2 * n * mc.hidden_size + 2 * mc.hidden_size * V + 8 * n)
        kernels.append({
            "name": "lm_stats_fwd", "id": "K8", "route": "cuda",
            "source": "dynamictreeattn_tpu_torch/csrc/lm_stats_fwd.cu",
            "replaces": "dynamictreeattn_tpu/ops/lm_stats.py:83",
            "launches": launches["lm_stats_fwd"], "max_abs_err": max(e_lse8, e_mx8),
            "ms": cuda_ms(lambda: lm_stats(hidden, w_lm), 10, flush),
            "plain_ms": cuda_ms(lambda: lm_stats_plain(hidden, w_lm), 2, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lib_lm, 5, flush),
            "library_call": "bf16 matmul + logsumexp, 16384-column chunks",
        })
    # the backward kernels, at the same inputs as their checks (K1's lse)
    di1 = torch.sum(do.float() * o1.float(), dim=-1)
    # library yardstick for the pair: one autograd backward of SDPA with the
    # dense bool mask (clones: inference tensors cannot be saved for backward)
    qs, ks, vs = (t.clone().requires_grad_() for t in (qs, ks, vs))
    with torch.enable_grad():
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask.clone(),
                                                                   scale=scale)
    do_s = do.reshape(1, hq, n, dh).clone()
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do_s,
                                                      retain_graph=True), 5, flush)
    del sdpa_out, qs, ks, vs
    with torch.inference_mode():
        bwd_args = (q4, k, v, ld)
        tail = (do, lse1, di1, scale, bq, bkv)
        split_errs = bwd_errs["split"]
        for name, kid, line, kind, fn, plain, meta_, err in (
            ("tree_attn_bwd_dq", "K11", 431, "dq", ta.tree_attn_bwd_dq, ta.tree_attn_bwd_dq_plain,
             meta[:3], split_errs["dq"]),
            ("tree_attn_bwd_dkv", "K12", 568, "dkv", ta.tree_attn_bwd_dkv, ta.tree_attn_bwd_dkv_plain,
             meta[3:6], max(split_errs["dk"], split_errs["dv"])),
        ):
            b_ms, b_by = bound_ms(*attention_bwd_work(ld, hq, hkv, dh, n, kind))
            kernels.append({
                "name": name, "id": kid, "route": "cuda",
                "source": "dynamictreeattn_tpu_torch/csrc/tree_attn_bwd.cu",
                "replaces": f"dynamictreeattn_tpu/ops/tree_attention.py:{line}",
                "launches": 0, "max_abs_err": err,
                "ms": cuda_ms(lambda: fn(*bwd_args, *meta_, *tail), 20, flush),
                "plain_ms": cuda_ms(lambda: plain(*bwd_args, *meta_, *tail), 2, flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": sdpa_bwd_ms,
                "library_call": "SDPA backward (dq, dk, dv), dense bool mask: one time for the "
                                "K11+K12 pair",
            })
        # K3 and K10: ms of the wrapper (fp32 scratch zeroed, the kernel, the
        # cast of the scratch to bf16), as the step runs it
        for name, kid, line, mode in (("tree_attn_bwd_cached", "K3", 1032, "cached"),
                                      ("tree_attn_bwd_fused", "K10", 715, "fused")):
            b_ms, b_by = bound_ms(*attention_bwd_work(ld, hq, hkv, dh, n, "fused"))
            kernels.append({
                "name": name, "id": kid, "route": "cuda",
                "source": "dynamictreeattn_tpu_torch/csrc/tree_attn_bwd_fused.cu",
                "replaces": f"dynamictreeattn_tpu/ops/tree_attention.py:{line}",
                "launches": 0, "max_abs_err": max(bwd_errs[mode].values()),
                "ms": cuda_ms(lambda: attention_bwd(ta, mode, *bwd_args, meta, *tail), 20, flush),
                "plain_ms": cuda_ms(lambda: attention_bwd(ta, mode, *bwd_args, meta, *tail, plain=True),
                                    2, flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": sdpa_bwd_ms,
                "library_call": "SDPA backward (dq, dk, dv), dense bool mask",
                "run_to_run_max_abs": max(bwd_repeat[mode, key] for key in ("dq", "dk", "dv")),
            })

        def lib_lm_bwd():
            a_ = (g_lse + g_ent * mx8)[:, None]
            dh_ = torch.zeros(hidden.shape, dtype=torch.float32, device=dev)
            dwT_ = torch.empty((V, mc.hidden_size), dtype=w_lm.dtype, device=dev)
            for c0 in range(0, V, 16384):
                wc = w_lm[:, c0:c0 + 16384]
                x_ = torch.matmul(hidden, wc).float()
                dl_ = (torch.exp(x_ - lse8[:, None]) * (a_ - g_ent[:, None] * x_)).to(hidden.dtype)
                dwT_[c0:c0 + 16384] = torch.matmul(dl_.t(), hidden)
                dh_ += torch.matmul(dl_, wc.t())
            return dh_, dwT_

        d = mc.hidden_size
        b_ms, b_by = bound_ms(3 * 2.0 * n * d * V, 2 * n * d + 2 * d * V + 12 * n + 2 * n * d + 2 * V * d)
        kernels.append({
            "name": "lm_stats_bwd", "id": "K9", "route": "cuda",
            "source": "dynamictreeattn_tpu_torch/csrc/lm_stats_bwd.cu",
            "replaces": "dynamictreeattn_tpu/ops/lm_stats.py:171",
            "launches": train_launches["lm_stats_bwd"], "max_abs_err": k9_err,
            "ms": cuda_ms(lambda: lm_stats_bwd(hidden, w_lm, lse8, mx8, g_lse, g_ent), 5, flush),
            "plain_ms": cuda_ms(lambda: lm_stats_bwd_plain(hidden, w_lm, lse8, mx8, g_lse, g_ent),
                                2, flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib_lm_bwd, 3, flush),
            "library_call": "bf16 matmuls of the vocab-chunked backward, 16384-column chunks",
        })
        # K4-K7 at the main path's shapes: layer 0's q/k/v of the trie
        (q_, k_, v_, qw_, kw_, cos_, sin_, eps_, norm_, gq_, gk_, gv_) = qk_main
        qk_calls = {
            "qk_prep_fwd_q": lambda f: f(q_, qw_, cos_, sin_, eps_, norm_),
            "qk_prep_fwd_kv": lambda f: f(k_, v_, kw_, cos_, sin_, eps_, norm_),
            "qk_prep_bwd_q": lambda f: f(gq_, q_, qw_, cos_, sin_, eps_, norm_),
            "qk_prep_bwd_kv": lambda f: f(gk_, gv_, k_, kw_, cos_, sin_, eps_, norm_),
        }
        qk_err_keys = {"qk_prep_fwd_q": ("q",), "qk_prep_fwd_kv": ("k", "v"),
                       "qk_prep_bwd_q": ("dq", "dqw"), "qk_prep_bwd_kv": ("dk", "dv", "dkw")}
        for name, kid, line in QK_KERNELS:
            heads = hq if name.endswith("_q") else hkv
            b_ms, b_by = bound_ms(0.0, qk_work(n, heads, dh, name[len("qk_prep_"):]))
            kfn, pfn = getattr(qp, name), getattr(qp, name + "_plain")
            kernels.append({
                "name": name, "id": kid, "route": "cuda",
                "source": "dynamictreeattn_tpu_torch/csrc/qk_prep.cu",
                "replaces": f"dynamictreeattn_tpu/ops/qk_prep.py:{line}",
                "launches": 0, "max_abs_err": max(qk_errs[key] for key in qk_err_keys[name]),
                "ms": cuda_ms(lambda: qk_calls[name](kfn), 20, flush),
                "plain_ms": cuda_ms(lambda: qk_calls[name](pfn), 5, flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library_call": "none: no single PyTorch call computes per-head RMSNorm + RoPE + "
                                "the head-major transpose",
            })
    # launches over the drives, each from counts of 0: the forward path, the
    # training path (tree + dense step, default backward), and the tree step
    # in each other backward mode
    drives = {"forward path": launches, "training path": train_launches,
              "split step": mode_launches["split"], "fused step": mode_launches["fused"]}
    for kd in kernels:
        kd["launches_by_drive"] = {drive: counts[kd["name"]] for drive, counts in drives.items()}
        kd["launches"] = sum(kd["launches_by_drive"].values())
    for kd in kernels:
        lib_ms = "none" if kd["library_ms"] is None else f"{kd['library_ms']:.3f} ms"
        log(f"{kd['id']} {kd['name']}: {kd['ms']:.4f} ms (bound {kd['bound_ms']:.4f} ms by "
            f"{kd['bound_by']}, plain {kd['plain_ms']:.2f} ms, library {lib_ms}), "
            f"{kd['launches']} launches ("
            + ", ".join(f"{drive} {c}" for drive, c in kd["launches_by_drive"].items() if c) + ")")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
