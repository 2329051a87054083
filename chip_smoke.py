#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (under /usr/local/cuda or on PATH); without a
card it exits non-zero and prints no result. Phases, each a hard failure:

1. build every CUDA source of the port (``dynamictreeattn_tpu_torch/csrc``)
   with nvcc for sm_90a, all at once;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes: the tree-attention forward, bound (K1) and online (K2), on
   layer 0's q/k/v of the trie below, walking the query-major work list
   that ``prepare`` built (two launches bit-equal; two bugs planted in the
   list, the heaviest tile's last sub-tile dropped and its diagonal
   sub-tile marked full, must move o through the kernels), through both
   branches of the bound dispatch, chosen on the card and read from the
   kernel's device-side branch record; the tree-attention backward in its three modes — "cached" (K3),
   "fused" (K10) and "split" (dq K11, dk/dv K12) — on the same q/k/v with
   (o, lse) from K1 and from K2, plus a small input where a dropped kv tile
   or an unmasked partial tile would fail the check several times over, and
   the largest difference between two launches (K11, K12 and the dk/dv of
   K3 and K10 must repeat bit-equal; the dq of K3 and K10 sums in no fixed
   order); the key-major work list of K3, K10 and K12 (its chunks, the most
   units one CTA walks before and after the split, scratch and dq bytes),
   two bugs planted in it that must move dk/dv through the kernels, the two
   planted forward-list bugs through K11 (they must move dq), and no work
   list or one built for another length, which the four backward wrappers
   must refuse; the LM-head statistics forward (K8) and backward (K9)
   (``lm_head_checks``) on the trie's final hidden states, plus ragged
   rows, vocabularies and temperature, a contiguous [d, V] head, hidden
   sizes 1536 and 896, two launches of each bit-equal and two bugs planted
   in K8's walk that must move lse; the qk-prep forward (K4 q, K5 k/v) and backward (K6 q, K7
   k/v) on layer 0's q/k/v projections, with seeded norm weights and
   cotangents, at the trie's length and a ragged one, and without the norm
   at Llama-3.2-3B and Qwen2.5-0.5B widths, plus three bugs planted in the
   plain version that the check must see, and each K6 / K7 call traced as
   exactly one kernel launch (dw summed on the card by its last CTA); then (2b, ``shapes_phase``) K1,
   K2, K3, K10, K11 and K12 at every (head_dim, group) pair of the dense
   configs, each against its plain version on random inputs over real trie
   metadata (K3/K10/K12 over a work list built for the shape's kv heads), with
   planted group-slicing bugs at the odd groups and, on the bench trie, the
   planted work-list bugs;
3. drive the forward path — Qwen3-0.6B at full width (28 layers, d=1024,
   16/8 heads, V=151936, bf16, random weights from seed 0) through
   ``TreeEngine.prepare`` -> ``TreeEngine.forward`` on the 1-group rollout
   trie of bench.py and on its dense packing (plus one tree forward with the
   online softmax, the path that runs K2) — and check tree == dense
   log-probs, a reference on a small input, the fused qk-prep path against
   the unfused one (``fused_qk="off"``), and that every forward kernel
   launched exactly as often as 28 layers need;
4. drive the training path — ``TreeEngine.loss_and_grad`` (remat, the
   default backward "auto" = "cached" (K3, for which ``prepare`` builds no
   slot schedule on the card), fused qk-prep) on the same tree and dense batches —
   and check that every forward/backward kernel of the path launched as
   often as 28 layers under remat need (and K10, K11, K12 never), that each
   layer's recompute took its forward's K1/K2 branch (both read from the
   device record), that one layer's attention forward and backward under
   the engine's default config make no host synchronisation
   (``torch.cuda.set_sync_debug_mode("error")``), tree == dense loss and
   per-parameter gradients, fused == unfused qk-prep, and a reference on a
   small input; then one tree step each with ``bwd_mode="split"`` and
   ``"fused"``, counted from 0 on its own, against the "cached" step;
5. time the host's ``prepare``, the forwards and the training steps (fused
   and unfused qk-prep; the three backward modes in turns), profile each by
   kernel class, and time each kernel beside its bound, its plain version
   and one library call as a yardstick (K1/K2 with the fraction of the
   bound they reach, and at the three bench shapes a log line beside the
   parent kernel's recorded times, which this run does not measure);
6. the sampler (``sampler_phase``) at the JAX package's GRPO decode shape —
   Qwen3-0.6B, 2 prompts of 1536 and 1100 tokens x 16 branches, 384 new
   tokens: the grouped-decode attention (K13), with t an int32 on the card
   and its grid sized for the branch cache, against its plain version (NaN
   in every cache column past plen and t, an adversarial input that three
   planted bugs must move by several tolerances, two launches bit-equal,
   Qwen2.5-0.5B and Llama-3.2-3B head layouts, one launch captured in a
   CUDA graph and replayed at other t bit-equal to eager launches); then
   one sampled ``generate_grouped(backend="kernel")`` through its replayed
   decode step with the counts from 0 (exactly 28 K13 launches per decode
   step, one capture), its sequences' log-probs (recorded inside the step
   from the logits each token was sampled from) against
   ``TreeEngine.forward`` on their trie; the replayed loop against the
   eager loop on the same step function (greedy, and top-k/top-p from one
   seed: tokens equal); greedy rollouts of 64 new tokens (branches equal;
   none of K13 for ``backend="reference"`` or the flat ``generate``); the
   full rollout's seconds, peak memory replayed vs eager, rollouts kernel
   vs reference in turns at 32 new tokens, the prefill, the capture, host
   ms and a profile of replayed and of eager decode steps, and K13 at
   t = 0, 191 and 383 beside its bound, its plain version and SDPA;
7. the second model family (``family_phase``): Qwen2.5-1.5B at full width
   (28 layers, d=1536, 12/2 heads, dh 128, GQA group 6, q/k/v bias, no
   qk-norm, V=151936, bf16, random weights from seed 0) through the same
   entry points on the same trie: the forward (K2, the online kernel, with
   K4/K5 without the norm and K8; K1 never) and the training step (K3 by
   "auto", K8, K9, K4-K7), exact launch counts from 0, tree == dense
   log-probs and step, fused == unfused qk-prep, the "fused" (K10) and
   "split" (K11/K12) steps against the "cached" one, a reference on a small
   input; forward and step timings in turns, the step by backward mode in
   turns, peak memory of the tree and of the dense step, a profile of each
   backward mode with its attention-backward class; then K8 and K9 at its
   hidden size (``lm_head_rows``: kernel, plain, library and bare-product
   times beside the bound) and K6 / K7 at its head layout without the norm
   (``qk_bwd_family_rows``).

Each phase prints its seconds. The last three lines are the per-kernel JSON, the card's name and power
limit from nvidia-smi, and the JSON status line.

    python3 chip_smoke.py --steps-only [--root DIR]

times only the tree training step in each backward mode, with its peak
memory, from the port under DIR (default: this checkout), and prints one
JSON line (``steps_ab``): run it on a checkout of another commit and on this
one, in turns, to compare the two in one call.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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
# K6 / K7 of the two-launch kernel this one replaced (a CTA per 64 (row,
# head) pairs, then one CTA summing the dw partials): their ms at the main
# path's shapes, recorded in PERF.md from this script's run on an NVIDIA H100
# 80GB HBM3 at 700 W
QK_PARENT_MS = {"qk_prep_bwd_q": 0.0552, "qk_prep_bwd_kv": 0.0423}
# kernels no run may launch any more: a profile that traces one fails
RETIRED_KERNELS = ("qk_prep_dw_reduce",)
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
# K13 vs plain, per element: o is bf16 (spacing at most 2^-7 of |o|); both
# round once from fp32 values that differ in summation order and in where P
# is rounded to bf16 (per-chunk vs running maxima), which may flip a rounding:
# allow two ulps, |diff| <= 2^-9 + 2^-6 * |ref|. Measured on an H100 at the
# sampler's shapes: at most one ulp (9.8e-4 at |o| < 0.25).
DECODE_O_ATOL, DECODE_O_RTOL = 2.0**-9, 2.0**-6
# The sampler phase: the JAX package's GRPO decode shape
# (scripts/tpu_decode_backend_ab.py: 2 prompts x 16 branches, 384 new
# tokens), with ragged prompts. The kernel path replays a captured decode
# step; the eager loops (the reference backend, the flat sampler, the eager
# kernel loop it is held against) are host-bound (~40 ms a step on an H100
# machine, PERF.md §5), so the sampled rollout, its exact K13 count and its
# sampled tokens' log-probs run all 384 new tokens, and the comparisons with
# eager loops and the kernel-vs-reference repeats in turns run fewer.
SAMPLER_P, SAMPLER_G, SAMPLER_LENS, SAMPLER_NEW = 2, 16, (1536, 1100), 384
SAMPLER_GREEDY_NEW, SAMPLER_TIMED_NEW = 64, 32
# the second family of the run (phase 7): no qk-norm (the online forward),
# GQA group 6, q/k/v bias
FAMILY_MODEL = "qwen2.5-1.5b"
# K1 / K2 ms of the mma.sync forward this kernel replaced, at the bench
# shapes (head_dim, group) of Qwen3-0.6B, Qwen2.5-1.5B and Llama-3.2-1B:
# recorded in PERF.md §6 from this script's run on an NVIDIA H100 80GB HBM3 at 700 W
FWD_PARENT_MS = {(128, 2): (0.6210, 0.6464), (128, 6): (0.4787, 0.5037), (64, 4): (0.8061, 0.8503)}
# K8 / K9 of the mma.sync kernels this version replaced, recorded in PERF.md
# from this script's runs on an NVIDIA H100 80GB HBM3 at 700 W: their timed
# ms at Qwen3-0.6B's shapes (§6), and their one launch's class in the
# Qwen2.5-1.5B tree step's profile (§5)
LM_PARENT_MS = {"lm_stats_fwd": 11.7377, "lm_stats_bwd": 24.1404,
                f"lm_stats_fwd@{FAMILY_MODEL}": 17.22, f"lm_stats_bwd@{FAMILY_MODEL}": 34.37}


def ptxas_usage(report: str) -> list[tuple[str, str]]:
    """[(kernel instantiation, "N registers, S bytes spill stores, ...")] from
    nvcc's ``-Xptxas -v`` report, names demangled by c++filt when it runs."""
    entries, name, spill = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split(":")[-1].strip() if ":" in line else line.strip()
        elif "Used" in line and "registers" in line and name:
            entries.append((name, line.split("Used", 1)[1].strip() + "; " + spill))
            name = None
    try:
        out = subprocess.run(["c++filt"], input="\n".join(n for n, _ in entries), capture_output=True,
                             text=True, check=True, timeout=30).stdout.splitlines()
        names = [o.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0] for o in out]
    except (OSError, subprocess.SubprocessError):
        names = [n for n, _ in entries]
    if len(names) != len(entries):
        names = [n for n, _ in entries]
    return [(n, usage) for n, (_, usage) in zip(names, entries)]


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


def cuda_ms(fn, iters: int, flush: torch.Tensor, clean: bool = False) -> float:
    """Mean device ms of fn() over `iters` launches, each with a cold L2
    (a 64 MB buffer is rewritten before each, outside the timed events,
    which leaves the L2 full of dirty lines that the launch writes back as
    it evicts them; with `clean`, the buffer is read instead, which leaves
    clean lines). The device first spins for ~2e7 cycles per launch (~10 ms
    at the H100's clock), so the host queues every launch before the device
    reaches it: a kernel shorter than its wrapper's host time would
    otherwise be timed with the host's gap in it."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(int(2e7) * iters)
    for e0, e1 in pairs:
        if clean:
            flush.view(torch.int64).sum()
        else:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in pairs) / iters


def turns_ms(*runs, rounds: int = 4, warm: bool = True):
    """([median ms of each run], [all times of each run]) on the host clock,
    each call synchronised, timed in turns after one warm-up each (unless
    `warm` is False: the caller ran them already), the order reversed every
    other round (a b b a a b ... for two runs): versions compared in one
    call, so that drift of the host or the card falls on all of them."""
    for run in runs if warm else ():
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


def plain_schedule(batch, ec) -> tuple:
    """(actions, flush) on the batch's device: the slot schedule that the
    plain K3 replays. ``prepare`` builds none on the card, where the kernel
    takes none."""
    from dynamictreeattn_tpu_torch.ops.tree_attention import cached_bwd_geometry
    from dynamictreeattn_tpu_torch.tries import build_block_meta, build_bwd_cache_sched

    bm = build_block_meta(batch.packed.last_desc, ec.block_q, ec.block_kv)
    sched = build_bwd_cache_sched(bm, cached_bwd_geometry(bm.q_ids.shape[0]))
    return tuple(torch.from_numpy(a).to(batch.last_desc.device) for a in (sched.actions, sched.flush))


def attention_bwd(ta, mode, q4, k, v, ld, meta, do, lse, di, scale, bq, bkv, plain=False, work=None,
                  qwork=None):
    """(dq, dk, dv) of backward mode `mode` ("cached", "fused", "split") from
    its kernels or, with `plain`, their plain versions; `meta` holds the six
    block arrays and the slot schedule (actions, flush) that the plain K3
    replays (the kernel takes none); `work` is the key-major work list that
    K3, K10 and K12 need, `qwork` the query-major one of K11."""
    tail = (do, lse, di, scale, bq, bkv)
    if plain:
        if mode == "split":
            return (ta.tree_attn_bwd_dq_plain(q4, k, v, ld, *meta[:3], *tail),
                    *ta.tree_attn_bwd_dkv_plain(q4, k, v, ld, *meta[3:6], *tail))
        if mode == "fused":
            return ta.tree_attn_bwd_fused_plain(q4, k, v, ld, *meta[:3], *tail)
        return ta.tree_attn_bwd_cached_plain(q4, k, v, ld, *meta[:3], *meta[6:8], *tail)
    if mode == "split":
        return (ta.tree_attn_bwd_dq(q4, k, v, ld, *meta[:3], *tail, work=qwork),
                *ta.tree_attn_bwd_dkv(q4, k, v, ld, *meta[3:6], *tail, work=work))
    if mode == "fused":
        return ta.tree_attn_bwd_fused(q4, k, v, ld, *meta[:3], *tail, work=work)
    return ta.tree_attn_bwd_cached(q4, k, v, ld, *meta[:6], None, None, *tail, work=work)


# backward mode -> the outputs its kernels must repeat bit-equal (fixed-order
# sums); K3's and K10's dq are summed across CTAs in no fixed order
BWD_REPEATS = {"split": ("dq", "dk", "dv"), "cached": ("dk", "dv"), "fused": ("dk", "dv")}
# K11 / K10 ms of the mma.sync kernels these versions replaced, at the bench
# shapes (head_dim, group) of Qwen3-0.6B, Qwen2.5-1.5B and Llama-3.2-1B:
# recorded in PERF.md §6 from this script's run on an NVIDIA H100 80GB HBM3 at 700 W
BWD_PARENT_MS = {(128, 2): (0.9742, 1.8667), (128, 6): (0.7737, 1.4303), (64, 4): (1.2604, 2.1227)}


def check_attention_bwd(ta, mode, label, q4, k, v, ld, meta, o, lse, do, scale, bq, bkv, work=None,
                        qwork=None):
    """Backward mode `mode`'s kernels against their plain versions on the
    same inputs; returns ({"dq"|"dk"|"dv": max|err|}, (dq, dk, dv) of the
    plain versions, {"dq"|...: max |difference| between two kernel runs}).
    Fails if an output of BWD_REPEATS[mode] differs between the two runs."""
    di = torch.sum(do.float() * o.float(), dim=-1)
    args = (q4, k, v, ld, meta, do, lse, di, scale, bq, bkv)
    got, again = (attention_bwd(ta, mode, *args, work=work, qwork=qwork),
                  attention_bwd(ta, mode, *args, work=work, qwork=qwork))
    torch.cuda.synchronize()
    want = attention_bwd(ta, mode, *args, plain=True)
    names = ("dq", "dk", "dv")
    errs = {name: check_rel(f"{label} {name}", g_, w_, BWD_REL_TOL)
            for name, g_, w_ in zip(names, got, want)}
    repeat = {name: float((a_.float() - b_.float()).abs().max()) for name, a_, b_ in zip(names, got, again)}
    moved = [name for name in BWD_REPEATS[mode] if repeat[name]]
    if moved:
        fail(f"{label}: {moved} differ between two launches on the same inputs ({repeat})")
    return errs, want, repeat


def rel_tols(bad: torch.Tensor, ref: torch.Tensor) -> float:
    """How many BWD_REL_TOL tolerances (of max|ref|) `bad` lies from `ref`."""
    return float((bad.float() - ref.float()).abs().max()) / (BWD_REL_TOL * float(ref.float().abs().max()))


def heaviest_parts(work) -> tuple[list, list]:
    """(spans, indices): the work list's (key tile, first unit, units) spans
    by tile and part, and the indices of the parts of the key tile with the
    most units (which must be split)."""
    chunks = work.chunks.cpu().numpy()
    heavy = int(np.argmax(np.bincount(chunks[:, 0], weights=chunks[:, 2])))
    rows = chunks[np.lexsort((chunks[:, 4], chunks[:, 0]))]  # by tile, then part
    mine = [i for i, r in enumerate(rows) if r[0] == heavy]
    if len(mine) < 2:
        fail(f"the heaviest key tile ({heavy}) is not split: the planted work-list bugs need a split tile")
    return [tuple(int(x) for x in r[:3]) for r in rows], mine


def mutated_work(work, how: str):
    """The key-major work list with one planted bug, run through the kernels:
    "drop" leaves out the last chunk of the key tile with the most units,
    "twice" gives that tile's first chunk a second time. The chunk table is
    rebuilt around the change, so the tile's fixed-order sum still
    completes and writes the wrong total."""
    from dynamictreeattn_tpu_torch.tries import kmajor_chunk_table

    spans, mine = heaviest_parts(work)
    if how == "drop":
        del spans[mine[-1]]
    else:
        spans.append(spans[mine[0]])
    table, n_parts, n_split = kmajor_chunk_table(spans)
    return dataclasses.replace(work, chunks=torch.from_numpy(table).to(work.chunks.device),
                               n_parts=n_parts, n_split=n_split)


def check_work_bugs(ta, label, q4, k, v, ld, meta, tail, work, ref) -> dict:
    """Both planted work-list bugs (``mutated_work``) through K12, K3 and K10 must
    move dk or dv by ADVERSARIAL_MIN_RATIO tolerances from the plain K12's
    `ref` (dk, dv) on `tail`'s inputs. The dropped chunk (late queries of a
    prompt tile, each of small weight) is held on an adversarial cotangent:
    `tail`'s do and di kept on that chunk's q rows only, zero elsewhere.
    Returns {bug: ratio}."""
    spans, mine = heaviest_parts(work)
    _, u0, nu = spans[mine[-1]]
    rows = torch.zeros(q4.shape[2], dtype=torch.bool, device=q4.device)
    for u in work.units[u0:u0 + nu].tolist():
        rows[(u >> 1):(u >> 1) + 64] = True
    do, lse, di, *rest = tail
    adv_tail = (do * rows[:, None].to(do.dtype), lse, di * rows, *rest)
    cases = {"drop": (adv_tail, ta.tree_attn_bwd_dkv_plain(q4, k, v, ld, *meta[3:6], *adv_tail)),
             "twice": (tail, ref)}
    ratios = {}
    for how, (tail_, ref_) in cases.items():
        bad = mutated_work(work, how)
        outs = {"K12": ta.tree_attn_bwd_dkv(q4, k, v, ld, *meta[3:6], *tail_, work=bad),
                "K3": ta.tree_attn_bwd_cached(q4, k, v, ld, *meta[:6], None, None, *tail_, work=bad)[1:],
                "K10": ta.tree_attn_bwd_fused(q4, k, v, ld, *meta[:3], *tail_, work=bad)[1:]}
        for kid, (dk_, dv_) in outs.items():
            ratios[f"{kid} {how}"] = max(rel_tols(dk_, ref_[0]), rel_tols(dv_, ref_[1]))
    log(f"{label}: planted work-list bugs (the heaviest tile's last chunk dropped, on a cotangent kept on "
        f"that chunk's {int(rows.sum())} q rows; its first chunk given twice) move dk/dv of the kernels by "
        + ", ".join(f"{key} {r:.1f}" for key, r in ratios.items()) + " tolerances")
    low = {key: r for key, r in ratios.items() if r < ADVERSARIAL_MIN_RATIO}
    if low:
        fail(f"{label}: the check does not expose the planted work-list bugs: {low}")
    return ratios


def mutated_qwork(work, how: str):
    """(the forward's work list with one planted bug, the bugged sub-tile's
    first key, the heaviest tile's first row): "drop" leaves out the
    heaviest tile's last live sub-tile (its diagonal one), "unmask" marks
    that tile's diagonal sub-tile -- partial: the causal triangle -- full."""
    tiles, entries = work.tiles.clone(), work.entries.clone()
    r0, e0, cnt = tiles[0].tolist()
    if how == "drop":
        tiles[0, 2] = cnt - 1
        return dataclasses.replace(work, tiles=tiles), int(entries[e0 + cnt - 1]) >> 1, r0
    i = e0 + int(torch.nonzero((entries[e0:e0 + cnt] >> 1) == r0)[0, 0])
    if not int(entries[i]) & 1:
        fail("the heaviest q tile's diagonal sub-tile is not partial")
    entries[i] -= 1
    return dataclasses.replace(work, entries=entries), r0, r0


def check_qwork_bugs(ta, label, q4, k, ld, meta, c, work, scale, bq, bkv) -> dict:
    """Both planted forward-list bugs (``mutated_qwork``) through K1 and K2
    must move o by ADVERSARIAL_MIN_RATIO tolerances from the plain version.
    Each is held on adversarial values: v zero but 64 on the bugged
    sub-tile's keys ("drop") or on its last 32 keys ("unmask": keys no row of
    the tile's first half may see). The kernels with the right list must
    pass on the same inputs. Returns {"K1 drop": ratio, ...}."""
    ratios = {}
    for how in ("drop", "unmask"):
        bad, c0, r0 = mutated_qwork(work, how)
        va = torch.zeros((q4.shape[0], q4.shape[2], q4.shape[3]), dtype=q4.dtype, device=q4.device)
        va[:, c0 + (32 if how == "unmask" else 0):c0 + 64] = 64.0
        args = (q4, k, va, ld, *meta[:3], scale, bq, bkv)
        for kid, run, plain in (("K1", lambda w: ta.tree_attn_fwd_bound(*args, c, work=w),
                                 lambda: ta.tree_attn_fwd_plain(*args, c=c)),
                                ("K2", lambda w: ta.tree_attn_fwd_online(*args, work=w),
                                 lambda: ta.tree_attn_fwd_plain(*args))):
            ref = plain()[0]
            check_close(f"{label} {kid} on the '{how}' adversarial values", run(work)[0], ref,
                        ATTN_O_ATOL, ATTN_O_RTOL)
            got = run(bad)[0]
            ratios[f"{kid} {how}"] = float(((got.float() - ref.float()).abs()
                                            / (ATTN_O_ATOL + ATTN_O_RTOL * ref.float().abs())).max())
    log(f"{label}: planted forward-list bugs (the heaviest tile's last live sub-tile dropped; its diagonal "
        "sub-tile marked full), on adversarial values, move o of the kernels by "
        + ", ".join(f"{key} {r:.1f}" for key, r in ratios.items()) + " tolerances")
    low = {key: r for key, r in ratios.items() if r < ADVERSARIAL_MIN_RATIO}
    if low:
        fail(f"{label}: the check does not expose the planted forward-list bugs: {low}")
    return ratios


def check_qwork_dq_bugs(ta, label, q4, k, ld, meta, lse, work, scale, bq, bkv) -> dict:
    """Both planted forward-list bugs (``mutated_qwork``) through K11 must
    move dq by ADVERSARIAL_MIN_RATIO tolerances from the plain version. Each
    is held on adversarial values: a seeded do, di = 0, and v zero but 64 on
    the bugged sub-tile's keys ("drop") or on its last 32 keys ("unmask":
    keys no row of the tile's first half may see), so that dS is nonzero
    only on those keys. K11 with the right list must pass on the same
    inputs. Returns {"K11 drop": ratio, ...}."""
    gen = torch.Generator(device=q4.device).manual_seed(7)
    do = torch.randn(q4.shape, generator=gen, device=q4.device).to(q4.dtype)
    di = torch.zeros(q4.shape[:3], dtype=torch.float32, device=q4.device)
    ratios = {}
    for how in ("drop", "unmask"):
        bad, c0, _ = mutated_qwork(work, how)
        va = torch.zeros((q4.shape[0], q4.shape[2], q4.shape[3]), dtype=q4.dtype, device=q4.device)
        va[:, c0 + (32 if how == "unmask" else 0):c0 + 64] = 64.0
        args = (q4, k, va, ld, *meta[:3], do, lse, di, scale, bq, bkv)
        ref = ta.tree_attn_bwd_dq_plain(*args)
        check_rel(f"{label} K11 on the '{how}' adversarial values", ta.tree_attn_bwd_dq(*args, work=work), ref,
                  BWD_REL_TOL)
        ratios[f"K11 {how}"] = rel_tols(ta.tree_attn_bwd_dq(*args, work=bad), ref)
    log(f"{label}: planted forward-list bugs (the heaviest tile's last live sub-tile dropped; its diagonal "
        "sub-tile marked full), on adversarial values, move dq of K11 by "
        + ", ".join(f"{key} {r:.1f}" for key, r in ratios.items()) + " tolerances")
    low = {key: r for key, r in ratios.items() if r < ADVERSARIAL_MIN_RATIO}
    if low:
        fail(f"{label}: the check does not expose the planted forward-list bugs in K11: {low}")
    return ratios


def qwork_stats(work, group: int, hkv: int) -> dict:
    """What the forward's work list does at one shape: q tiles, live
    sub-tiles (full / partial), CTAs and the sub-tiles the heaviest and the
    mean CTA walk (each over a slice of two group heads)."""
    tiles, entries = work.tiles.cpu().numpy(), work.entries.cpu().numpy()
    ctas = len(tiles) * hkv * -(-group // 2)
    return {"q_tiles": int(len(tiles)), "sub_tiles": int(len(entries)),
            "full": int((entries & 1 == 0).sum()), "partial": int((entries & 1).sum()), "ctas": ctas,
            "max_cta_sub_tiles": int(tiles[:, 2].max()),
            "mean_cta_sub_tiles": round(float(tiles[:, 2].mean()), 2)}


def work_stats(work, group: int, hkv: int, dh: int, n_sms: int) -> dict:
    """What the key-major work list does at one shape: chunks, the most
    (q sub-tile, group head) units one CTA walks before the split (a whole
    key tile) and after it, the mean per SM, the split tiles' scratch bytes
    and the fp32 bytes K3 adds into its dq scratch (64 x dh per unit, by
    bulk reduce-add, the traffic per-thread atomics would carry)."""
    chunks = work.chunks.cpu().numpy()
    n_units = int(chunks[:, 2].sum())
    return {"chunks": int(len(chunks)), "ctas": int(len(chunks)) * hkv, "bound_units": work.bound * group,
            "max_cta_units_before": int(np.bincount(chunks[:, 0], weights=chunks[:, 2]).max()) * group,
            "max_cta_units_after": int(chunks[:, 2].max()) * group,
            "mean_units_per_sm": round(n_units * group * hkv / n_sms, 1),
            "split_tiles": work.n_split, "scratch_bytes": hkv * (work.n_parts * 2 * 64 * dh * 4 + work.n_split * 4),
            "dq_reduce_bytes": n_units * group * hkv * 64 * dh * 4}


def sdpa_ms(q4, k, v, ld, do, scale, flush):
    """(forward ms, backward ms) of SDPA with the dense bool tree mask on
    these inputs, the kv heads repeated over the group: one PyTorch call as
    the library yardstick of the tree-attention kernels (never used by the
    port); the backward is one autograd backward giving dq, dk and dv."""
    hkv, group, n, dh = q4.shape
    pos = torch.arange(n, device=q4.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] <= ld.long()[None, :])
    qs, ks, vs = (t.clone().reshape(1, hkv * group, n, dh) for t in
                  (q4, k.repeat_interleave(group, dim=0), v.repeat_interleave(group, dim=0)))
    with torch.inference_mode():
        fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale), 10, flush)
    qs, ks, vs = (t.requires_grad_() for t in (qs, ks, vs))
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)
    do_s = do.reshape(out.shape).clone()
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do_s, retain_graph=True), 5, flush)
    return fwd, bwd


# The (head_dim, GQA group) pairs of the dense MODEL_CONFIGS, each held at one
# config's head layout: the slice's pair (Qwen2.5-1.5B) and one dh-64 pair
# (Llama-3.2-1B) on the bench trie, with kernels-JSON rows; the others on a
# trie of the bench batch's first 4 sequences (n ~ 2.5k, so the plain loops
# stay cheap).
SHAPE_CONFIGS = (("qwen3-0.6b", "small"), ("llama-3.2-3b", "small"), ("qwen3-4b", "small"),
                 ("qwen3-14b", "small"), ("qwen2.5-1.5b", "bench"), ("qwen2.5-7b", "small"),
                 ("llama-3.2-1b", "bench"), ("qwen2.5-0.5b", "small"))
# kernel id -> (name, CUDA source under csrc/, line of the replaced JAX function)
ATTN_KERNELS = {
    "K1": ("tree_attn_fwd_bound", "tree_attn_fwd.cu", 248), "K2": ("tree_attn_fwd_online", "tree_attn_fwd.cu", 80),
    "K11": ("tree_attn_bwd_dq", "tree_attn_bwd.cu", 431), "K12": ("tree_attn_bwd_dkv", "tree_attn_bwd_kmajor.cu", 568),
    "K3": ("tree_attn_bwd_cached", "tree_attn_bwd_kmajor.cu", 1032),
    "K10": ("tree_attn_bwd_fused", "tree_attn_bwd_kmajor.cu", 715),
}
# kernel id -> the outputs that must repeat bit-equal across two launches
ATTN_REPEATS = {"K1": ("o", "lse"), "K2": ("o", "lse"), "K11": ("dq",), "K12": ("dk", "dv"),
                "K3": ("dk", "dv"), "K10": ("dk", "dv")}


def shapes_phase(ta, engine, tries, flush) -> list[dict]:
    """2b. K1, K2, K3, K10, K11 and K12 at every (head_dim, group) pair of
    the dense configs (SHAPE_CONFIGS), each against its plain version on
    random bf16 q/k/v/do (seeded) and real trie metadata (`tries`: {"bench",
    "small"} -> TokenTrie): o/lse at the ATTN tolerances, dq/dk/dv at
    BWD_REL_TOL with K2's (o, lse); K1, K2, K11, K12 and the dk/dv of K3 and
    K10 bit-equal across two launches (ATTN_REPEATS), the run-to-run
    difference of K3's and K10's dq printed; each kernel's ms. K3, K10 and
    K12 walk a work list built for the shape's kv heads; its chunks, the
    most units one CTA walks before and after the split, scratch and dq
    bytes are printed, and on the bench trie the planted work-list bugs
    (``check_work_bugs``) must fail. At the odd groups, planted
    group-slicing bugs (two heads swapped, the last slice dropped) must move
    the plain outputs by ADVERSARIAL_MIN_RATIO tolerances. Returns
    kernels-JSON rows of the bench-trie pairs (launches 0, filled in by the
    caller)."""
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS

    dev = engine.device
    batches = {which: engine.prepare(trie) for which, trie in tries.items()}
    scheds = {which: plain_schedule(batch, engine.cfg) for which, batch in batches.items()}
    bq, bkv = engine.cfg.block_q, engine.cfg.block_kv
    gen = torch.Generator(device=dev).manual_seed(3)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for cname, which in SHAPE_CONFIGS:
        mc = MODEL_CONFIGS[cname]
        hq, hkv, dh = mc.num_attention_heads, mc.num_key_value_heads, mc.head_dim
        group = hq // hkv
        batch = batches[which]
        n, ld, qwork = batch.n_padded, batch.last_desc, batch.qmajor_work
        meta = (*batch.meta, *scheds[which])
        scale = dh**-0.5

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q4, k, v, do = rnd(hkv, group, n, dh), rnd(hkv, n, dh), rnd(hkv, n, dh), rnd(hkv, group, n, dh)
        work = ta.kmajor_work(ld, *meta[3:6], bq, bkv, hkv, dh, dev)  # balanced for this shape's kv heads
        stats = work_stats(work, group, hkv, dh, n_sms)
        with torch.inference_mode():
            c = ta._score_bound(q4, k, scale)
            fwd_args = (q4, k, v, ld, *meta[:3], scale, bq, bkv)
            o2, lse2 = ta.tree_attn_fwd_online(*fwd_args, work=qwork)
            di = torch.sum(do.float() * o2.float(), dim=-1)
            tail = (do, lse2, di, scale, bq, bkv)
            bwd_args = (q4, k, v, ld)
            # id -> (kernel call, plain call, output names)
            calls = {
                "K1": (lambda: ta.tree_attn_fwd_bound(*fwd_args, c, work=qwork),
                       lambda: ta.tree_attn_fwd_plain(*fwd_args, c=c), ("o", "lse")),
                "K2": (lambda: ta.tree_attn_fwd_online(*fwd_args, work=qwork),
                       lambda: ta.tree_attn_fwd_plain(*fwd_args), ("o", "lse")),
                "K11": (lambda: (ta.tree_attn_bwd_dq(*bwd_args, *meta[:3], *tail, work=qwork),),
                        lambda: (ta.tree_attn_bwd_dq_plain(*bwd_args, *meta[:3], *tail),), ("dq",)),
                "K12": (lambda: ta.tree_attn_bwd_dkv(*bwd_args, *meta[3:6], *tail, work=work),
                        lambda: ta.tree_attn_bwd_dkv_plain(*bwd_args, *meta[3:6], *tail), ("dk", "dv")),
                "K3": (lambda: attention_bwd(ta, "cached", *bwd_args, meta, *tail, work=work),
                       lambda: attention_bwd(ta, "cached", *bwd_args, meta, *tail, plain=True),
                       ("dq", "dk", "dv")),
                "K10": (lambda: attention_bwd(ta, "fused", *bwd_args, meta, *tail, work=work),
                        lambda: attention_bwd(ta, "fused", *bwd_args, meta, *tail, plain=True),
                        ("dq", "dk", "dv")),
            }
            errs, repeat, plain_ms, ms, refs = {}, {}, {}, {}, {}
            for kid, (run, plain, names) in calls.items():
                got, again = run(), run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = plain()
                torch.cuda.synchronize()
                plain_ms[kid] = (time.perf_counter() - t0) * 1e3
                refs[kid] = dict(zip(names, want))
                label = f"{kid} {cname} (dh {dh}, group {group})"
                errs[kid] = max(
                    check_close(f"{label} {nm}", g_, w_, ATTN_O_ATOL, ATTN_O_RTOL) if nm == "o"
                    else check_close(f"{label} {nm}", g_, w_, ATTN_LSE_ATOL) if nm == "lse"
                    else check_rel(f"{label} {nm}", g_, w_, BWD_REL_TOL)
                    for nm, g_, w_ in zip(names, got, want))
                diffs = {nm: float((a_.float() - b_.float()).abs().max()) for nm, a_, b_ in zip(names, got, again)}
                repeat[kid] = max(diffs.values())
                if any(diffs[nm] for nm in ATTN_REPEATS[kid]):
                    fail(f"{label}: two launches on the same inputs differ: {diffs}")
                ms[kid] = cuda_ms(run, 20 if which == "bench" else 5, flush)
        log(f"shapes {cname}: head_dim {dh}, group {group}, {hkv} kv heads, n={n}, max C "
            f"{float(c.max()):.2f}: max|err| " + ", ".join(f"{kid} {e:.3e}" for kid, e in errs.items())
            + f" (o {ATTN_O_ATOL}+{ATTN_O_RTOL}*|ref|, lse {ATTN_LSE_ATOL}, grads {BWD_REL_TOL}*max|ref|); "
            "K1/K2/K11/K12 and the dk/dv of K3/K10 bit-equal across two launches, the dq of K3/K10 run "
            f"to run {repeat['K3']:.3e}/{repeat['K10']:.3e}; ms " + ", ".join(
                f"{kid} {t:.4f} ({t / hq:.5f} per q head)" for kid, t in ms.items()))
        log(f"shapes {cname}: K3/K10/K12 work list {stats}; K1/K2/K11 work list {qwork_stats(qwork, group, hkv)}")
        if which == "bench":
            with torch.inference_mode():
                check_work_bugs(ta, f"shapes {cname} (dh {dh}, group {group})", *bwd_args, meta, tail, work,
                                (refs["K12"]["dk"], refs["K12"]["dv"]))

        if group % 2:
            # planted group-slicing bugs, through the plain outputs: two group
            # heads' rows swapped, and the last (one-head) slice dropped
            o_ref, dq_ref = refs["K2"]["o"], refs["K10"]["dq"]

            def swapped(t):
                return t[:, [1, 0, *range(2, group)]]

            def dropped(t):
                out = t.clone()
                out[:, group - 1] = 0
                return out

            def o_tols(bad):
                return float(((bad.float() - o_ref.float()).abs()
                              / (ATTN_O_ATOL + ATTN_O_RTOL * o_ref.float().abs())).max())

            with torch.inference_mode():
                do_cut = dropped(do)  # the last slice's heads add nothing to dk/dv
                dk_cut, dv_cut = ta.tree_attn_bwd_dkv_plain(
                    *bwd_args, *meta[3:6], do_cut, lse2, torch.sum(do_cut.float() * o2.float(), dim=-1),
                    scale, bq, bkv)
            ratios = {"o, heads 0/1 swapped": o_tols(swapped(o_ref)),
                      "o, last slice dropped": o_tols(dropped(o_ref)),
                      "dq, heads 0/1 swapped": rel_tols(swapped(dq_ref), dq_ref),
                      "dq, last slice dropped": rel_tols(dropped(dq_ref), dq_ref),
                      "dk, last slice dropped": rel_tols(dk_cut, refs["K10"]["dk"]),
                      "dv, last slice dropped": rel_tols(dv_cut, refs["K10"]["dv"])}
            log(f"shapes {cname}: group-slicing bugs move the outputs by " + ", ".join(
                f"{how} {r:.1f}" for how, r in ratios.items()) + " tolerances")
            low = {how: r for how, r in ratios.items() if r < ADVERSARIAL_MIN_RATIO}
            if low:
                fail(f"the shape check does not expose group-slicing bugs: {low}")

        if which != "bench":
            continue
        lib_fwd, lib_bwd = sdpa_ms(q4, k, v, ld, do, scale, flush)
        for kid, (kname, source, line) in ATTN_KERNELS.items():
            if kid in ("K1", "K2"):
                work = attention_work(ld, hq, hkv, dh, n, kid == "K1")
            else:
                work = attention_bwd_work(ld, hq, hkv, dh, n,
                                          {"K11": "dq", "K12": "dkv"}.get(kid, "fused"))
            b_ms, b_by = bound_ms(*work)
            rows.append({
                "name": f"{kname}@{cname}", "id": kid, "route": "cuda",
                "source": f"dynamictreeattn_tpu_torch/csrc/{source}",
                "replaces": f"dynamictreeattn_tpu/ops/tree_attention.py:{line}",
                "shape": {"config": cname, "head_dim": dh, "group": group, "kv_heads": hkv, "n": n},
                "launches": 0, "max_abs_err": errs[kid], "ms": ms[kid], "plain_ms": plain_ms[kid],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_fwd if kid in ("K1", "K2") else lib_bwd,
                "library_call": ("SDPA forward" if kid in ("K1", "K2") else "SDPA backward (dq, dk, dv)")
                                + ", dense bool mask, kv heads repeated over the group",
                **({"work_list": stats} if kid in ("K3", "K10", "K12") else {}),
                "bound_fraction": b_ms / ms[kid],
            })
    return rows


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


def qk_work(n: int, H: int, dh: int, kind: str, norm: bool = True) -> float:
    """Bytes one qk-prep kernel must move: bf16 activations read and written
    once, fp32 cos/sin read once, with the norm the bf16 norm weight (and
    the fp32 dw; the backward reads x only with the norm)."""
    act = 2 * n * H * dh  # one [n, H*dh] bf16 tensor
    rope = 2 * 4 * n * dh
    n_act = {"fwd_q": 2, "fwd_kv": 4, "bwd_q": 3, "bwd_kv": 5}[kind] - (kind.startswith("bwd") and not norm)
    extra = (2 * dh + (4 * dh if kind.startswith("bwd") else 0)) if norm else 0
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
    if "lm_bwd" in name or "lm_stats_bwd" in name:  # lm_bwd_dlogits, lm_bwd_gemm
        return "LM-head stats bwd (K9)"
    if "lm_fwd" in name or "lm_stats" in name:  # lm_fwd_partial, lm_fwd_merge
        return "LM-head stats fwd (K8)"
    if "decode_attn_kernel" in name:
        return "grouped-decode attention (K13)"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmuls (cuBLAS)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies"
    return "elementwise / norms / rope / gathers"


def device_kernels(run) -> list[str]:
    """The names of the device kernels that one traced run() launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [evt.name for evt in prof.events() if evt.device_type == DeviceType.CUDA]


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
    retired = [name for name in by_name if any(old in name for old in RETIRED_KERNELS)]
    if retired:
        fail(f"profile {label}: retired kernels launched: {retired}")
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


def first_diff(a: np.ndarray, b: np.ndarray) -> int:
    """First index where token rows a and b differ, -1 if none."""
    ne = np.nonzero(a != b)[0]
    return int(ne[0]) if len(ne) else -1


def decode_work(plens, G: int, hq: int, hkv: int, dh: int, t: int):
    """(flops, bytes) K13 needs at step t: per q row, 4*dh flops for each
    visible column (prompt cols < plen, own cols < t, self); the prompt
    cache's columns < plen and each branch's columns < t read once, q,
    k_self, v_self read once, o written once (bf16)."""
    P = len(plens)
    cols = sum(plens) + P * (t + 1)
    flops = 4.0 * dh * G * hq * cols
    kv_bytes = 2 * 2 * dh * hkv * (sum(plens) + P * G * t)
    nbytes = kv_bytes + 2 * P * G * dh * (2 * hq + 2 * hkv) + 4 * P
    return flops, nbytes


def step_counts(bwd_mode: str, L: int) -> dict:
    """Launches one training step of L layers needs under remat with backward
    mode `bwd_mode`: forward + recompute ("fwd": K1 + K2), one backward of
    its kernels only."""
    return {"fwd": 2 * L, **{key: L if mode == bwd_mode else 0
                             for mode, keys in BWD_KERNELS.items() for key in keys},
            "lm_stats_fwd": 1, "lm_stats_bwd": 1, "qk_prep_fwd_q": 2 * L, "qk_prep_fwd_kv": 2 * L,
            "qk_prep_bwd_q": L, "qk_prep_bwd_kv": L}


def counted(counts: dict, like: dict) -> dict:
    return {"fwd": counts["tree_attn_fwd_bound"] + counts["tree_attn_fwd_online"],
            **{key: counts[key] for key in like if key != "fwd"}}


def check_step(label, got, ref) -> None:
    """Loss rel and per-parameter grad rel err of step `got` against step
    `ref`; fails past the bars."""
    from dynamictreeattn_tpu_torch.utils import compare_grads

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


def check_logprobs(label, got: dict, ref: dict) -> None:
    """Per-sequence log-probs `got` against `ref` (same ids): summed to
    TREE_DENSE_SUM_RTOL relative, per token to TREE_DENSE_TOKEN_ATOL."""
    if set(got) != set(ref):
        fail(f"{label}: per-sequence ids differ")
    worst, sum_g, sum_r = 0.0, 0.0, 0.0
    for bid, r in ref.items():
        g = got[bid]
        if g.shape != r.shape or not (np.isfinite(g).all() and np.isfinite(r).all()):
            fail(f"{label}: seq {bid}: bad log-prob vector shape {g.shape} / finiteness")
        worst = max(worst, float(np.abs(g - r).max()))
        sum_g += float(g.astype(np.float64).sum())
        sum_r += float(r.astype(np.float64).sum())
    rel = abs(sum_g - sum_r) / abs(sum_r)
    log(f"{label}: summed log-prob {sum_g:.4f} vs {sum_r:.4f} (rel {rel:.3e}, tol {TREE_DENSE_SUM_RTOL}); "
        f"per-token max|diff| {worst:.4f} (tol {TREE_DENSE_TOKEN_ATOL}: bf16 through every layer)")
    if rel > TREE_DENSE_SUM_RTOL or worst > TREE_DENSE_TOKEN_ATOL:
        fail(f"{label}: log-probs disagree")


def check_small_forward(label, engine, ref_engine, params, trie) -> None:
    """Per-token log-probs of the kernel path (`engine`) against the dense
    reference path (`ref_engine`: reference attention + plain vocab fold) on
    a small trie, to SMALL_REF_TOKEN_ATOL."""
    lp_k = engine.forward(params, engine.prepare(trie))
    lp_r = ref_engine.forward(params, ref_engine.prepare(trie))
    worst = max(float(np.abs(lp_k[i] - lp_r[i]).max()) for i in lp_k)
    log(f"{label} vs reference path: per-token max|diff| {worst:.4f} (tol {SMALL_REF_TOKEN_ATOL}: "
        "bf16 through every layer, other attention arithmetic)")
    if worst > SMALL_REF_TOKEN_ATOL:
        fail(f"{label}: kernel path disagrees with the reference path")


def sampler_phase(params, mc, dev, engine, flush) -> tuple[dict, dict]:
    """6. the sampler: K13 against its plain version at the GRPO decode
    shape, with t as an int32 on the card and the grid sized for the branch
    cache (NaN past plen and t, an adversarial input, other head layouts,
    two launches and a graph replay bit-equal to an eager launch), then
    ``generate_grouped`` driven at full width through its replayed decode
    step with the counts from 0, the replayed loop against the eager one,
    greedy parity, the sampled sequences' log-probs against the tree engine,
    timings, the capture, peak memory and profiles of replayed and eager
    decode steps. Returns (K13's kernels-JSON row, the sampler drive's
    launch counts)."""
    import dynamictreeattn_tpu_torch.models.generate  # noqa: F401  (the module, not the function)
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, generate, generate_grouped, init_cache
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.ops.decode_attention import (
        BRANCH_CHUNK, PROMPT_CHUNK, decode_attention_grouped, decode_attention_grouped_plain,
    )
    from dynamictreeattn_tpu_torch.tries import TokenTrie
    gm = sys.modules["dynamictreeattn_tpu_torch.models.generate"]

    P, G, NEW = SAMPLER_P, SAMPLER_G, SAMPLER_NEW
    L, V = mc.num_hidden_layers, mc.vocab_size
    hq, hkv, dh = mc.num_attention_heads, mc.num_key_value_heads, mc.head_dim
    Lp = max(SAMPLER_LENS)
    lens = np.array(SAMPLER_LENS, np.int32)
    t_mid, t_last = NEW // 2 - 1, NEW - 1  # 191 and 383: mid-rollout and the last step
    rng = np.random.default_rng(0)
    prompts = np.zeros((P, Lp), np.int32)
    for p, n in enumerate(lens):
        prompts[p, :n] = rng.integers(1, V, size=n)
    plens = torch.as_tensor(lens, device=dev)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def on_card(t):
        return torch.tensor(t, dtype=torch.int32, device=dev)

    def decode_inputs(hq_, hkv_, dh_, t, poison):
        """Random bf16 K13 inputs at the sampler's shape (q, k unit-RMS as
        after the qk-norm), without t; with `poison`, NaN in every cache
        column >= plen and >= t: a kernel that reads and multiplies them
        fails."""
        q, ks, vs = rnd(P, G, hq_, dh_), rnd(P, G, hkv_, dh_), rnd(P, G, hkv_, dh_)
        kp, vp = rnd(P, hkv_, Lp, dh_), rnd(P, hkv_, Lp, dh_)
        kc, vc = rnd(P, G, hkv_, NEW, dh_), rnd(P, G, hkv_, NEW, dh_)
        if poison:
            for p, n in enumerate(lens):
                kp[p, :, n:] = float("nan")
                vp[p, :, n:] = float("nan")
            kc[:, :, :, t:] = float("nan")
            vc[:, :, :, t:] = float("nan")
        return q, ks, vs, kp, vp, kc, vc, plens

    def tolerances(got, ref) -> float:
        return float(((got.float() - ref.float()).abs()
                      / (DECODE_O_ATOL + DECODE_O_RTOL * ref.float().abs())).max())

    # ---- K13 vs plain at the main path's shape, then two other head layouts;
    # t on the card, the grid and workspace sized for the branch cache (Nc)
    k13_err = 0.0
    layouts = [("Qwen3-0.6B", (hq, hkv, dh), (0, 1, t_mid, t_last))]
    for name in ("qwen2.5-0.5b", "llama-3.2-3b"):
        c_ = MODEL_CONFIGS[name]
        layouts.append((name, (c_.num_attention_heads, c_.num_key_value_heads, c_.head_dim), (0, t_mid)))
    with torch.inference_mode():
        for label, (hq_, hkv_, dh_), ts in layouts:
            for t in ts:
                args = decode_inputs(hq_, hkv_, dh_, t, poison=True)
                got, again = decode_attention_grouped(*args, on_card(t)), decode_attention_grouped(*args, on_card(t))
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"K13 {label} t={t}: two launches on the same inputs differ")
                want = decode_attention_grouped_plain(*args, t)
                err = check_close(f"K13 {label} t={t}", got, want, DECODE_O_ATOL, DECODE_O_RTOL)
                k13_err = max(k13_err, err)
                log(f"K13 {label} heads {hq_}/{hkv_} dh {dh_}, P={P} G={G} plens {lens.tolist()} Lp={Lp} "
                    f"Nc={NEW} t={t} (an int32 on the card), NaN in every column >= plen and >= t: max|err| "
                    f"{err:.3e} (max|ref| {float(want.float().abs().max()):.3e}; tol {DECODE_O_ATOL:.4g} + "
                    f"{DECODE_O_RTOL:.4g}*|ref|: two bf16 ulps), finite, two launches bit-equal")

        # one launch captured in a CUDA graph at t_mid, replayed with t moved
        # on the card: bit-equal to an eager launch at each t (NaN past plen)
        args = decode_inputs(hq, hkv, dh, NEW, poison=True)
        t_graph = on_card(t_mid)
        decode_attention_grouped(*args, t_graph)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with _build.captured_launches() as captured, torch.cuda.graph(graph):
            replayed = decode_attention_grouped(*args, t_graph)
        if captured != {"decode_attn": 1}:
            fail(f"K13 capture counted {captured}, expected one decode_attn launch")
        for t in (0, 1, t_mid, t_last, NEW):
            t_graph.fill_(t)
            graph.replay()
            eager = decode_attention_grouped(*args, t)
            torch.cuda.synchronize()
            if not torch.equal(replayed, eager):
                fail(f"K13 graph replay at t={t} differs from an eager launch")
        del graph
        log(f"K13 captured once at t={t_mid}, replayed at t=0, 1, {t_mid}, {t_last}, {NEW} (t moved on the "
            "card): bit-equal to an eager launch at each")

        # adversarial: q and every branch key aligned (score ~11 against ~N(0, 2)
        # for the prompt), branch values (-1)^g * (1 + 0.5 * chunk index), 100
        # past t; each planted bug, run through the plain version, must move o
        # by ADVERSARIAL_MIN_RATIO tolerances or more
        for t in (t_mid, t_last):
            q, ks, vs, kp, vp, _, _, _ = decode_inputs(hq, hkv, dh, t, poison=False)
            q = torch.full_like(q, 2.0)
            kc = torch.full((P, G, hkv, NEW, dh), 0.5, dtype=bf16, device=dev)
            col = torch.arange(NEW, device=dev)
            sign = torch.tensor([(-1.0) ** g for g in range(G)], device=dev)
            vals = torch.where(col < t, sign[:, None] * (1 + 0.5 * (col // BRANCH_CHUNK)), 100.0)
            vc = vals[None, :, None, :, None].expand(P, G, hkv, NEW, dh).to(bf16).contiguous()
            args = (q, ks, vs, kp, vp, kc, vc, plens)
            got = decode_attention_grouped(*args, on_card(t))
            want = decode_attention_grouped_plain(*args, t)
            err = check_close(f"K13 adversarial t={t}", got, want, DECODE_O_ATOL, DECODE_O_RTOL)
            k13_err = max(k13_err, err)
            bugs = {
                "a neighbour branch's columns": ((q, ks, vs, kp, vp, kc.roll(1, 1), vc.roll(1, 1), plens), t),
                "the last branch chunk dropped": (args, (t - 1) // BRANCH_CHUNK * BRANCH_CHUNK),
                "one column past t read": (args, t + 1),
            }
            ratios = {how: tolerances(decode_attention_grouped_plain(*bad, bad_t), want)
                      for how, (bad, bad_t) in bugs.items()}
            log(f"K13 adversarial t={t}: kernel max|err| {err:.3e}; " + ", ".join(
                f"'{how}' moves o by {r:.1f} tolerances" for how, r in ratios.items()))
            for how, r in ratios.items():
                if r < ADVERSARIAL_MIN_RATIO:
                    fail(f"the K13 check does not expose '{how}' at t={t}: {r:.2f} tolerances")
        # a dropped prompt chunk, on random inputs at t = 0 (prompt and self only)
        args = decode_inputs(hq, hkv, dh, 0, poison=False)
        cut = plens - ((plens - 1) % PROMPT_CHUNK + 1)
        r = tolerances(decode_attention_grouped_plain(*args[:7], cut, 0), decode_attention_grouped_plain(*args, 0))
        log(f"K13 random input t=0: 'the last prompt chunk dropped' moves o by {r:.1f} tolerances")
        if r < ADVERSARIAL_MIN_RATIO:
            fail(f"the K13 check does not expose a dropped prompt chunk: {r:.2f} tolerances")

    # ---- the main path: generate_grouped, sampled, through the replayed
    # decode step, counts from 0
    def seeded(seed=0):
        return torch.Generator(device=dev).manual_seed(seed)

    # the log-prob of each sampled token under the logits it was drawn from
    # (the prefill's, then each decode step's), written inside the sampler at
    # an index kept on the card: a graph replay runs it too
    lp_rec = {}
    real_sampler = gm._sampler

    def recording_sampler(*args):
        sample = real_sampler(*args)

        def rec(logits):
            tok = sample(logits)
            lp = torch.log_softmax(logits.float(), -1).gather(-1, tok[..., None])[..., 0]
            if not lp_rec:  # the first call is the prefill's, eager: no allocation is captured
                lp_rec["buf"] = torch.zeros((NEW, *lp.shape), device=dev)
                lp_rec["i"] = torch.zeros(1, dtype=torch.long, device=dev)
            lp_rec["buf"].index_copy_(0, lp_rec["i"], lp[None])
            lp_rec["i"].add_(1)
            return tok

        return rec

    captures = []
    real_captured_step = gm._captured_step

    def timed_capture(*args):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out_ = real_captured_step(*args)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t0_)
        return out_

    real_use_graph = gm._use_graph

    def eager_loop(fn):
        """fn() with generate_grouped's decode loop eager (a host loop over
        the same step function, no graph)."""
        gm._use_graph = lambda device, backend: False
        try:
            return fn()
        finally:
            gm._use_graph = real_use_graph

    gm._captured_step = timed_capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    gm._sampler = recording_sampler
    try:
        t0 = time.perf_counter()
        sampled = generate_grouped(params, mc, prompts, lens, G, NEW, generator=seeded(), temperature=1.0,
                                   backend="kernel")
        torch.cuda.synchronize()
        sampled_s = time.perf_counter() - t0
    finally:
        gm._sampler = real_sampler
    launches = _build.launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = NEW - 1  # the prefill's logits give the first token
    log(f"sampler path launches (generate_grouped, backend=\"kernel\", P={P} G={G} max_new={NEW}, one eager "
        f"step, one capture, {steps - 1} replays): { {k: v for k, v in launches.items() if v} }")
    if len(captures) != 1:
        fail(f"the rollout captured its decode step {len(captures)} times, expected once")
    if launches["decode_attn"] != L * steps:
        fail(f"K13 launched {launches['decode_attn']} times, expected {L} x {steps} decode steps")
    if sampled.shape != (P, G, NEW) or sampled.min() < 0 or sampled.max() >= V:
        fail(f"sampled tokens: shape {sampled.shape}, range [{sampled.min()}, {sampled.max()}]")
    distinct = [len({tuple(row) for row in sampled[p]}) for p in range(P)]
    log(f"sampled rollout (replayed step): {sampled_s:.3f} s for {P * G * NEW} tokens "
        f"({P * G * NEW / sampled_s:.1f} sampled tokens/s, prefill, the capture ({captures[0]:.3f} s) and the "
        f"log-prob recording included); distinct branches per prompt {distinct}; max_memory_allocated "
        f"{peak_gib:.3f} GiB")
    if min(distinct) < 2:
        fail("temperature-1 branches of a prompt are all equal")

    # ---- the replayed loop against the eager loop on the same step function
    # (tokens equal draw for draw: the same kernels, and the generator
    # registered with the graph), then greedy: kernel, reference and the flat
    # sampler on the duplicated batch
    TNEW = SAMPLER_TIMED_NEW
    for label, kw in (("greedy", {"greedy": True}),
                      ("top-k 50 / top-p 0.9", {"generator": 3, "top_k": 50, "top_p": 0.9})):
        def run(kw=kw):
            k = dict(kw)
            if "generator" in k:
                k["generator"] = seeded(k["generator"])
            return generate_grouped(params, mc, prompts, lens, G, TNEW, **k)

        replayed_toks, eager_toks = run(), eager_loop(run)
        if not np.array_equal(replayed_toks, eager_toks):
            fail(f"{label}: the replayed loop's tokens differ from the eager loop's at "
                 + str([first_diff(replayed_toks[p, g], eager_toks[p, g]) for p in range(P) for g in range(G)]))
        log(f"{label}, max_new={TNEW}: the replayed loop's tokens equal the eager loop's")

    greedy_s = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize()
        greedy_s[label] = time.perf_counter() - t0_
        return out_

    GNEW = SAMPLER_GREEDY_NEW
    greedy_k = timed("kernel (replayed)", lambda: generate_grouped(params, mc, prompts, lens, G, GNEW, greedy=True))
    if any(not (greedy_k[p] == greedy_k[p, :1]).all() for p in range(P)):
        fail("greedy kernel path: the branches of a prompt differ")
    _build.reset_launches()
    greedy_r = timed("reference (eager)", lambda: generate_grouped(params, mc, prompts, lens, G, GNEW, greedy=True,
                                                                   backend="reference"))
    ref_launches = _build.LAUNCHES["decode_attn"]
    _build.reset_launches()
    flat = timed("flat (eager)", lambda: generate(params, mc, np.repeat(prompts, G, 0), np.repeat(lens, G), GNEW,
                                                  greedy=True))
    flat_launches = _build.LAUNCHES["decode_attn"]
    if ref_launches or flat_launches:
        fail(f"K13 launched by backend=\"reference\" ({ref_launches}) or the flat sampler ({flat_launches})")
    log(f"greedy, max_new={GNEW}, first index where the replayed kernel path's tokens differ (not gated: bf16 "
        "near-ties may flip a token): from backend=\"reference\" "
        + str([first_diff(greedy_k[p, 0], greedy_r[p, 0]) for p in range(P)])
        + ", from the flat sampler " + str([first_diff(greedy_k[p, 0], flat[p * G]) for p in range(P)])
        + " (-1: none); reference branches equal "
        + str([bool((greedy_r[p] == greedy_r[p, :1]).all()) for p in range(P)])
        + "; rollout s (once each): " + ", ".join(f"{k} {v:.3f}" for k, v in greedy_s.items()))

    # ---- the sampled sequences' log-probs, as the decode steps gave them
    # while sampling, vs TreeEngine.forward on their trie
    n_rec = int(lp_rec["i"])
    if n_rec != NEW:
        fail(f"recorded {n_rec} sampling steps, expected {NEW}")
    rep = lp_rec["buf"].permute(1, 2, 0).reshape(P * G, NEW).cpu().numpy().astype(np.float64)
    lp_rec.clear()
    seqs = [np.concatenate([prompts[p, :lens[p]], sampled[p, g]]) for p in range(P) for g in range(G)]
    lp_eng = engine.forward(params, engine.prepare(TokenTrie(seqs)))
    eng = np.stack([lp_eng[i][lens[i // G] - 1:] for i in range(P * G)]).astype(np.float64)
    tok_diff = float(np.abs(eng - rep).max())
    sum_rel = abs(eng.sum() - rep.sum()) / abs(eng.sum())
    log(f"sampled sequences' log-probs, from the replayed decode steps that sampled them, vs "
        f"TreeEngine.forward on their trie ({sum(len(s) for s in seqs)} tokens): summed {rep.sum():.4f} vs "
        f"{eng.sum():.4f} "
        f"(rel {sum_rel:.3e}, tol {TREE_DENSE_SUM_RTOL}); per-token max|diff| {tok_diff:.4f} (tol "
        f"{TREE_DENSE_TOKEN_ATOL}: bf16 through 28 layers, other attention arithmetic)")
    if not (np.isfinite(rep).all() and np.isfinite(eng).all()):
        fail("non-finite sampled-token log-probs")
    if sum_rel > TREE_DENSE_SUM_RTOL or tok_diff > TREE_DENSE_TOKEN_ATOL:
        fail("the sampler's log-probs disagree with the tree engine's")

    # ---- timings: the full rollout (replayed), peak memory replayed vs
    # eager, kernel vs reference rollouts in turns, the prefill, and windows
    # of replayed and eager decode steps (host clock vs the profile's busy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_grouped(params, mc, prompts, lens, G, NEW, generator=seeded())
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    log(f"rollout max_new={NEW}, sampled, replayed step: {rollout_s:.3f} s ({P * G * NEW / rollout_s:.1f} sampled "
        f"tokens/s, prefill and capture ({captures[-1]:.3f} s) included)")

    def rollout(backend, new=TNEW):
        return generate_grouped(params, mc, prompts, lens, G, new, generator=seeded(), backend=backend)

    peaks = {}
    for label, fn in (("replayed", lambda: rollout("kernel")),
                      ("eager", lambda: eager_loop(lambda: rollout("kernel")))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
    (k_ms, r_ms), turns = turns_ms(lambda: rollout("kernel"), lambda: rollout("reference"), rounds=2,
                                   warm=False)  # both paths ran above
    n_tok = P * G * TNEW
    log(f"rollout max_new={TNEW}, sampled, in turns (medians of 2): kernel (replayed) {k_ms:.2f} ms "
        f"({n_tok / k_ms * 1e3:.1f} sampled tokens/s), reference (eager) {r_ms:.2f} ms "
        f"({n_tok / r_ms * 1e3:.1f} tokens/s); kernel " + " ".join(f"{t:.2f}" for t in turns[0])
        + ", reference " + " ".join(f"{t:.2f}" for t in turns[1])
        + f"; max_memory_allocated at max_new={TNEW}: replayed {peaks['replayed']:.3f} GiB, eager loop "
          f"{peaks['eager']:.3f} GiB")
    with torch.inference_mode():
        # decode steps on the sampled tokens, over the prompts' caches and
        # zero branch caches (the work of a step does not depend on them)
        cache = init_cache(mc, P, Lp, bf16, dev)
        gm._prefill(params, mc, prompts, lens, cache["k"], cache["v"])
        toks = torch.as_tensor(sampled, device=dev).long()
        shape = (L, P, G, hkv, NEW, dh)
        ckc, cvc = torch.zeros(shape, dtype=bf16, device=dev), torch.zeros(shape, dtype=bf16, device=dev)
        layers = gm._layer_list(params)

        def step(tok, t):
            return gm._decode_step_grouped(params, mc, tok, plens, t, cache["k"], cache["v"], ckc, cvc,
                                           "kernel", layers=layers)[0]

        pre = []
        for _ in range(3):
            c2 = init_cache(mc, P, Lp, bf16, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gm._prefill(params, mc, prompts, lens, c2["k"], c2["v"])
            torch.cuda.synchronize()
            pre.append((time.perf_counter() - t0) * 1e3)
        del c2
        step_gen = seeded()
        sample = gm._sampler(step_gen, 1.0, False, 0, None, None)
        t_lo, n_win = t_mid, 8

        def eager_window():
            with torch.inference_mode():
                for t in range(t_lo, t_lo + n_win):
                    sample(step(toks[:, :, t], t))

        # the replayed step over static buffers, as generate_grouped runs it
        state = gm._grouped_state(toks[:, :, t_lo], NEW, None)
        state["t"].fill_(t_lo)

        def run_step():
            gm._grouped_step(step, sample, state, None)

        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run_step()
        t_cap = time.perf_counter()
        replay = real_captured_step(run_step, side, step_gen)
        capture_ms = (time.perf_counter() - t_cap) * 1e3

        def replay_window():
            with torch.inference_mode():
                state["t"].fill_(t_lo)
                for _ in range(n_win):
                    replay()

        win = {"replayed": [], "eager": []}
        for _ in range(3):
            for label, fn in (("replayed", replay_window), ("eager", eager_window)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                win[label].append((time.perf_counter() - t0) * 1e3 / n_win)
        logits = step(toks[:, :, t_lo], t_lo)
        # one step's logits through the reference attention on the same caches
        # (not gated: what the greedy first-difference indices above rest on)
        ref_logits = gm._decode_step_grouped(params, mc, toks[:, :, t_lo], plens, t_lo, cache["k"],
                                             cache["v"], ckc, cvc, "reference", layers=layers)[0]
        step_diff = float((ref_logits - logits).abs().max())
        lm_ms = cuda_ms(lambda: gm._logits(params, mc, rnd(P * G, mc.hidden_size)), 20, flush)
        sample_ms = cuda_ms(lambda: sample(logits), 20, flush)
    host_step = {k: float(np.median(v)) for k, v in win.items()}
    log(f"prefill of {P} prompts ({'/'.join(str(n) for n in lens)} tokens, LM head on the last): "
        f"{float(np.median(pre)):.2f} ms (median of 3); decode step at t={t_lo}..{t_lo + n_win - 1} "
        f"(sampling included), host clock, median of 3 windows: replayed {host_step['replayed']:.3f} ms, eager "
        f"{host_step['eager']:.2f} ms; capture of one step {capture_ms:.2f} ms; alone, CUDA events: LM head "
        f"{lm_ms:.4f} ms, sampling {sample_ms:.4f} ms; step t={t_lo} logits, kernel vs reference attention: "
        f"max|diff| {step_diff:.4f} (not gated)")
    for label, fn in (("replayed", replay_window), ("eager", eager_window)):
        layers_ms = profile_run(fn, f"grouped decode ({label}), {n_win} steps at t={t_lo}..")
        if layers_ms:
            busy = sum(layers_ms.values()) / n_win
            log(f"decode step ({label}): host {host_step[label]:.3f} ms vs device busy {busy:.3f} ms per step "
                f"(profile), idle share {1 - busy / host_step[label]:.3f} of the untraced host time; by class per "
                "step: " + ", ".join(f"{k} {v / n_win:.3f}" for k, v in sorted(
                    layers_ms.items(), key=lambda kv: -kv[1]))
                + f" (matmuls include the LM head, elementwise the sampling: {lm_ms:.3f} and "
                  f"{sample_ms:.3f} ms alone)")
    del replay

    # ---- K13's kernels-JSON row: at t = 191 (mid-rollout); t = 0 and 383
    # (the first and the last step) under their own keys
    row = {"name": "decode_attn", "id": "K13", "route": "cuda",
           "source": "dynamictreeattn_tpu_torch/csrc/decode_attn.cu",
           "replaces": "dynamictreeattn_tpu/ops/decode_attention.py:45",
           "launches": launches["decode_attn"], "max_abs_err": k13_err,
           "library_call": "SDPA, enable_gqa, each branch's [prompt | own cols < t | self] keys "
                           "concatenated, bool mask past plen (reads the prompt cache G times)"}
    with torch.inference_mode():
        for t in (t_mid, 0, t_last):
            args = decode_inputs(hq, hkv, dh, t, poison=False)
            t_dev = on_card(t)
            q, ks, vs, kp, vp, kc, vc = args[:7]
            cat = [torch.cat([p_[:, None].expand(P, G, hkv, Lp, dh), c_[:, :, :, :t], s_[:, :, :, None]],
                             dim=3).reshape(P * G, hkv, Lp + t + 1, dh)
                   for p_, c_, s_ in ((kp, kc, ks), (vp, vc, vs))]
            mask = torch.ones((P, G, 1, 1, Lp + t + 1), dtype=torch.bool, device=dev)
            mask[..., :Lp] = torch.arange(Lp, device=dev) < plens[:, None, None, None, None]
            mask = mask.reshape(P * G, 1, 1, Lp + t + 1)
            qs = q.reshape(P * G, hq, 1, dh)

            def lib():
                return torch.nn.functional.scaled_dot_product_attention(qs, *cat, attn_mask=mask,
                                                                        enable_gqa=True)

            lib_diff = float((lib().reshape(q.shape).float() - decode_attention_grouped(*args, t_dev).float())
                             .abs().max())
            sfx = "" if t == t_mid else f"_t{t}"
            row["ms" + sfx] = cuda_ms(lambda: decode_attention_grouped(*args, t_dev), 20, flush)
            row["plain_ms" + sfx] = cuda_ms(lambda: decode_attention_grouped_plain(*args, t), 3, flush)
            row["bound_ms" + sfx], row["bound_by" + sfx] = bound_ms(*decode_work(list(lens), G, hq, hkv,
                                                                                 dh, t))
            row["library_ms" + sfx] = cuda_ms(lib, 10, flush)
            log(f"K13 at t={t}: {row['ms' + sfx]:.4f} ms (bound {row['bound_ms' + sfx]:.4f} ms by "
                f"{row['bound_by' + sfx]}, plain {row['plain_ms' + sfx]:.2f} ms, SDPA "
                f"{row['library_ms' + sfx]:.4f} ms; SDPA vs kernel max|diff| {lib_diff:.3e})")
    gm._captured_step = real_captured_step
    return row, launches


def lm_head_checks(hidden, w_lm, g_lse, g_ent) -> dict:
    """Phase 2's K8 / K9 checks: at the main path's final hidden states and
    head (with seeded cotangents g_lse, g_ent of (lse, entropy)), at ragged
    rows and vocabularies with T = 0.7, a contiguous [d, V] head, and random
    inputs at the other hidden sizes that run end to end or are the smallest
    (1536, 896) at a small ragged n; two launches of each kernel bit-equal;
    two bugs planted in K8's walk (the plan handed to the kernel) must move
    lse by ADVERSARIAL_MIN_RATIO tolerances. Returns {"K8", "K9": max|err|}."""
    from dynamictreeattn_tpu_torch.ops.lm_stats import (
        lm_fwd_plan, lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain,
    )

    dev = hidden.device
    n, V = hidden.shape[0], w_lm.shape[1]
    errs = {"K8": 0.0, "K9": 0.0}
    gen = torch.Generator(device=dev).manual_seed(4)

    def k8(label, hh, ww, it=1.0):
        got, again = lm_stats(hh, ww, it), lm_stats(hh, ww, it)
        torch.cuda.synchronize()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            fail(f"K8 {label}: two launches on the same inputs differ (splits merge in a fixed order)")
        want = lm_stats_plain(hh, ww, it)
        e = [check_close(f"K8 {label} {what}", g_, w_, LM_ATOL) for g_, w_, what in zip(got, want, ("lse", "mean_x"))]
        errs["K8"] = max(errs["K8"], *e)
        log(f"K8 {label} (hidden {tuple(hh.shape)}, W {tuple(ww.shape)}, T={1 / it:g}): lse max|err| {e[0]:.3e}, "
            f"mean_x max|err| {e[1]:.3e} (tol {LM_ATOL}: fp32 statistics of bf16 products summed in another "
            "order); two launches bit-equal")
        return got, want

    def k9(label, hh, ww, lse_, mx_, gl, ge, it=1.0):
        got, again = lm_stats_bwd(hh, ww, lse_, mx_, gl, ge, it), lm_stats_bwd(hh, ww, lse_, mx_, gl, ge, it)
        torch.cuda.synchronize()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            fail(f"K9 {label}: two launches on the same inputs differ (every output tile is written once)")
        want = lm_stats_bwd_plain(hh, ww, lse_, mx_, gl, ge, it)
        e_dh = check_rel(f"K9 {label} dh", got[0], want[0], LM_BWD_REL_TOL)
        e_dw = check_rel(f"K9 {label} dWT", got[1], want[1], LM_BWD_REL_TOL)
        errs["K9"] = max(errs["K9"], e_dh, e_dw)
        log(f"K9 {label}: dh max|err| {e_dh:.3e} (max|ref| {float(want[0].abs().max()):.3e}), dWT max|err| "
            f"{e_dw:.3e} (max|ref| {float(want[1].abs().max()):.3e}) (tol {LM_BWD_REL_TOL}*max|ref|: bf16 "
            "outputs, dl rounded to bf16 from logits summed in another order); two launches bit-equal")

    (lse8, mx8), (lse8p, _) = k8("at the main path's shapes", hidden, w_lm)
    k9("at the main path's shapes", hidden, w_lm, lse8, mx8, g_lse, g_ent)
    # ragged edges: rows not a multiple of 128, vocabularies not a multiple
    # of 256 (V - 77; V = 179, less than one tile: 77 masked columns, which
    # left unmasked would move lse by ~0.3), T = 0.7
    hr = hidden[: n - 50]
    for vr in (V - 77, 179):
        label = f"ragged n={hr.shape[0]} V={vr}"
        (lse_r, mx_r), _ = k8(label, hr, w_lm[:, :vr], 1 / 0.7)
        k9(label + " T=0.7", hr, w_lm[:, :vr], lse_r, mx_r, g_lse[: n - 50], g_ent[: n - 50], 1 / 0.7)
    # a head passed as a contiguous [d, V] tensor, copied by the wrapper
    k8("contiguous [d, V] head", hidden, w_lm[:, :32768].contiguous())
    # other hidden sizes: Qwen2.5-1.5B's and the smallest of MODEL_CONFIGS
    for d_, it in ((1536, 1.0), (896, 1 / 0.7)):
        hh = torch.randn(300, d_, generator=gen, device=dev).to(torch.bfloat16)
        ww = (torch.randn(V, d_, generator=gen, device=dev) * d_**-0.5).to(torch.bfloat16).t()
        (lse_d, mx_d), _ = k8(f"d={d_} n=300", hh, ww, it)
        k9(f"d={d_} n=300 T={1 / it:g}", hh, ww, lse_d, mx_d, *torch.randn(2, 300, generator=gen, device=dev), it)
    # planted bugs in the walk: the plan the kernel is handed
    S, T, grid = lm_fwd_plan(n, V, torch.cuda.get_device_properties(dev).multi_processor_count)
    if min(S, T) < 2:
        fail(f"K8 plan ({S} splits of {T} tiles) leaves no room to plant the walk bugs")
    for how, plan in ((f"splits one vocab tile short ({T - 1} of {T} tiles each)", (S, T - 1, grid)),
                      (f"the last of {S} splits never run", (S - 1, T, grid))):
        bad, _ = lm_stats(hidden, w_lm, _plan=plan)
        ratio = float((bad - lse8p).abs().max()) / LM_ATOL
        log(f"K8 adversarial: the walk with {how} moves lse by {ratio:.1f} tolerances")
        if ratio < ADVERSARIAL_MIN_RATIO:
            fail(f"the K8 check does not expose a walk with {how}: {ratio:.1f} tolerances")
    return errs


def lm_head_rows(hidden, w_lm, g_lse, g_ent, flush, errs=None, config=None) -> list[dict]:
    """Kernels-JSON rows of K8 and K9 at (hidden, w_lm): kernel, plain and
    library times (CUDA events, cold L2), bound, and `products_ms`, the
    cuBLAS time of the bare products at the same shapes (one [n, d] x [d, V]
    bf16 matmul for K8; for K9 that and the two matmuls of dhidden and dWT
    from the materialised [n, V] product), which the port never calls.
    `errs` ({"K8", "K9": max|err|}) from phase 2's checks, or (None) the
    kernels are checked against their plain versions here. `config` names
    rows at another model's shapes ("name@config")."""
    from dynamictreeattn_tpu_torch.ops.lm_stats import lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain

    n, d = hidden.shape
    V = w_lm.shape[1]
    suffix = f"@{config}" if config else ""
    with torch.inference_mode():
        lse, mx = lm_stats(hidden, w_lm)
        if errs is None:
            want = lm_stats_plain(hidden, w_lm)
            got9, want9 = lm_stats_bwd(hidden, w_lm, lse, mx, g_lse, g_ent), lm_stats_bwd_plain(
                hidden, w_lm, lse, mx, g_lse, g_ent)
            errs = {"K8": max(check_close(f"K8{suffix} {w_}", g_, r_, LM_ATOL)
                              for g_, r_, w_ in zip((lse, mx), want, ("lse", "mean_x"))),
                    "K9": max(check_rel(f"K9{suffix} {w_}", g_, r_, LM_BWD_REL_TOL)
                              for g_, r_, w_ in zip(got9, want9, ("dh", "dWT")))}
            del got9, want9
            log(f"K8/K9{suffix} at hidden {tuple(hidden.shape)}, W {tuple(w_lm.shape)}: max|err| "
                f"{errs['K8']:.3e} / {errs['K9']:.3e} (tols {LM_ATOL} / {LM_BWD_REL_TOL}*max|ref|)")

        def lib_fwd():
            parts = [torch.logsumexp(torch.matmul(hidden, w_lm[:, c0:c0 + 16384]).float(), dim=-1)
                     for c0 in range(0, V, 16384)]
            return torch.logsumexp(torch.stack(parts), dim=0)

        def lib_bwd():
            a_ = (g_lse + g_ent * mx)[:, None]
            dh_ = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
            dwT_ = torch.empty((V, d), dtype=w_lm.dtype, device=hidden.device)
            for c0 in range(0, V, 16384):
                wc = w_lm[:, c0:c0 + 16384]
                x_ = torch.matmul(hidden, wc).float()
                dl_ = (torch.exp(x_ - lse[:, None]) * (a_ - g_ent[:, None] * x_)).to(hidden.dtype)
                dwT_[c0:c0 + 16384] = torch.matmul(dl_.t(), hidden)
                dh_ += torch.matmul(dl_, wc.t())
            return dh_, dwT_

        def products_bwd():
            x_ = torch.matmul(hidden, w_lm)
            return torch.matmul(x_, w_lm.t()), torch.matmul(x_.t(), hidden)

        rows = []
        for name, kid, line, fn, plain, lib, lib_call, products, iters, work in (
            ("lm_stats_fwd", "K8", 83, lambda: lm_stats(hidden, w_lm), lambda: lm_stats_plain(hidden, w_lm),
             lib_fwd, "bf16 matmul + logsumexp, 16384-column chunks", lambda: torch.matmul(hidden, w_lm), 10,
             (2.0 * n * d * V, 2 * n * d + 2 * d * V + 8 * n)),
            ("lm_stats_bwd", "K9", 171, lambda: lm_stats_bwd(hidden, w_lm, lse, mx, g_lse, g_ent),
             lambda: lm_stats_bwd_plain(hidden, w_lm, lse, mx, g_lse, g_ent), lib_bwd,
             "bf16 matmuls of the vocab-chunked backward, 16384-column chunks", products_bwd, 5,
             (3 * 2.0 * n * d * V, 2 * n * d + 2 * d * V + 12 * n + 2 * n * d + 2 * V * d)),
        ):
            b_ms, b_by = bound_ms(*work)
            k_ms = cuda_ms(fn, iters, flush)
            rows.append({
                "name": name + suffix, "id": kid, "route": "cuda",
                "source": f"dynamictreeattn_tpu_torch/csrc/{name}.cu",
                "replaces": f"dynamictreeattn_tpu/ops/lm_stats.py:{line}",
                "launches": 0, "max_abs_err": errs[kid],
                "ms": k_ms, "plain_ms": cuda_ms(plain, 2, flush),
                "bound_ms": b_ms, "bound_by": b_by, "bound_fraction": b_ms / k_ms,
                "library_ms": cuda_ms(lib, 3, flush), "library_call": lib_call,
                "products_ms": cuda_ms(products, 3, flush),
                "products_call": "the bare products alone in cuBLAS (bf16 matmuls at the same shapes), not "
                                 "the library call of the function",
                "shape": {"config": config or MODEL, "n": n, "hidden_size": d, "vocab": V},
            })
    return rows


def qk_bwd_family_rows(depth: torch.Tensor, flush) -> list[dict]:
    """K6 / K7 at the second family's head layout (FAMILY_MODEL: no norm, so
    no x, no dw and no ticket) on random bf16 inputs at the trie's n: two
    launches bit-equal, against the plain version, timed beside the bound
    and the plain version (phase 2 traces the no-norm instantiations as one
    launch a call)."""
    import dynamictreeattn_tpu_torch.ops.qk_prep as qp
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.models.qwen3 import rope_tables

    mc = MODEL_CONFIGS[FAMILY_MODEL]
    hq, hkv, dh, n, dev = mc.num_attention_heads, mc.num_key_value_heads, mc.head_dim, depth.shape[0], depth.device
    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    cos, sin = rope_tables(depth, dh, mc.rope_theta, mc.rope_scaling_tuple)
    q, k, gq, gk, gv = rnd(n, hq * dh), rnd(n, hkv * dh), rnd(hq, n, dh), rnd(hkv, n, dh), rnd(hkv, n, dh)
    ones, eps = torch.ones(dh, dtype=torch.bfloat16, device=dev), mc.rms_norm_eps
    calls = {"qk_prep_bwd_q": ("K6", 105, hq, ("dq",), lambda f: f(gq, q, ones, cos, sin, eps, False)),
             "qk_prep_bwd_kv": ("K7", 127, hkv, ("dk", "dv"), lambda f: f(gk, gv, k, ones, cos, sin, eps, False))}
    rows = []
    for name, (kid, line, heads, keys, call) in calls.items():
        label = f"{kid} {name}@{FAMILY_MODEL} ({heads} heads, dh {dh}, no norm, random, n={n})"
        kfn, pfn = getattr(qp, name), getattr(qp, name + "_plain")
        got, again, want = ([t for t in call(f) if t is not None] for f in (kfn, kfn, pfn))
        torch.cuda.synchronize()
        if any(not torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{label}: two runs on the same inputs differ")
        errs = [check_close(f"{label} {key}", a, b, *qk_tol(b, key)) for key, a, b in zip(keys, got, want)]
        b_ms, b_by = bound_ms(0.0, qk_work(n, heads, dh, name[len("qk_prep_"):], norm=False))
        k_ms = cuda_ms(lambda: call(kfn), 20, flush)
        rows.append({
            "name": f"{name}@{FAMILY_MODEL}", "id": kid, "route": "cuda",
            "source": "dynamictreeattn_tpu_torch/csrc/qk_prep.cu",
            "replaces": f"dynamictreeattn_tpu/ops/qk_prep.py:{line}",
            "launches": 0, "max_abs_err": max(errs), "ms": k_ms,
            "ms_clean_l2": cuda_ms(lambda: call(kfn), 20, flush, clean=True),
            "plain_ms": cuda_ms(lambda: call(pfn), 5, flush), "bound_ms": b_ms, "bound_by": b_by,
            "bound_fraction": b_ms / k_ms, "library_ms": None,
            "library_call": "none: no single PyTorch call computes RoPE^T + the transpose back",
            "shape": {"config": FAMILY_MODEL, "heads": heads, "head_dim": dh, "norm": False},
        })
        log(f"{label}: two runs bit-equal, "
            + ", ".join(f"{key} max|err| {e:.3e}" for key, e in zip(keys, errs))
            + f"; {k_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({b_ms / k_ms:.3f} of it)")
    return rows


def family_phase(seqs, attachs, dev) -> dict:
    """7. the second model family at full width (FAMILY_MODEL, random
    weights from seed 0) through the engine's entry points on the bench
    trie: the forward and the training step with exact launch counts from
    0, their checks, timings in turns, peak memory and a profile. Returns
    {drive: launch counts} of its four drives."""
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine, pack_sequences_dense
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    mc = MODEL_CONFIGS[FAMILY_MODEL]
    L = mc.num_hidden_layers
    label = FAMILY_MODEL
    params = init_params(mc, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    ec = EngineConfig()
    engine = TreeEngine(mc, ec, device=dev)
    unfused = TreeEngine(mc, dataclasses.replace(ec, fused_qk="off"), device=dev)
    modes = {mode: TreeEngine(mc, dataclasses.replace(ec, bwd_mode=mode), device=dev)
             for mode in ("fused", "split")}
    tree_batch = engine.prepare(TokenTrie(seqs, attachs))
    dense_batch = engine.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=ec.pad_multiple))
    n_dense_tokens = sum(len(s_) for s_ in seqs)
    log(f"{label}: {L} layers, d={mc.hidden_size}, heads {mc.num_attention_heads}/"
        f"{mc.num_key_value_heads}, head_dim {mc.head_dim}, qk-norm {mc.use_qk_norm}, q/k/v bias "
        f"{mc.attention_bias}, V={mc.vocab_size}; tree n={tree_batch.n_padded}, dense n={dense_batch.n_padded}")

    def expect(what: str, counts: dict, want: dict) -> None:
        full = {key: want.get(key, 0) for key in counts}
        log(f"{label} {what} launches: { {k: v for k, v in counts.items() if v} }")
        if counts != full:
            fail(f"{label} {what}: launch counts {counts}, expected {full}")

    # ---- the forward: K2 (no qk-norm: the online kernel), never K1
    fwd_one = {"tree_attn_fwd_online": L, "qk_prep_fwd_q": L, "qk_prep_fwd_kv": L, "lm_stats_fwd": 1}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    lp_tree = engine.forward(params, tree_batch)
    expect("tree forward", _build.launches(), fwd_one)
    lp_dense = engine.forward(params, dense_batch)
    fwd_launches = _build.launches()
    expect("forward path (tree + dense)", fwd_launches, {k: 2 * v for k, v in fwd_one.items()})
    fwd_peak = torch.cuda.max_memory_allocated() / 2**30
    check_logprobs(f"{label} forward, tree vs dense", lp_tree, lp_dense)
    check_logprobs(f"{label} forward, fused vs unfused qk-prep", lp_tree, unfused.forward(params, tree_batch))
    small_trie = TokenTrie([s_[:192] for s_ in seqs[:4]], attachs[:4])
    ref_engine = TreeEngine(mc, dataclasses.replace(ec, attn_backend="reference", loss_mode="vocab"),
                            device=dev)
    check_small_forward(f"{label} small input", engine, ref_engine, params, small_trie)
    del lp_tree, lp_dense

    # ---- the training step: "auto" = "cached" (K3), remat, fused qk-prep
    def step_want(mode: str) -> dict:
        want = step_counts(mode, L)
        return {"tree_attn_fwd_online": want.pop("fwd"), **want}

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_tree = engine.loss_and_grad(params, tree_batch)
    expect("tree step", _build.launches(), step_want("cached"))
    tree_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    step_dense = engine.loss_and_grad(params, dense_batch)
    train_launches = _build.launches()
    expect("training path (tree + dense step)", train_launches,
           {k: 2 * v for k, v in step_want("cached").items()})
    dense_peak = torch.cuda.max_memory_allocated() / 2**30
    train_peak = max(tree_peak, dense_peak)
    check_step(f"{label} training tree vs dense", step_tree, step_dense)
    del step_dense
    check_step(f"{label} training tree, fused vs unfused qk-prep", step_tree,
               unfused.loss_and_grad(params, tree_batch))
    drives = {f"{label} forward path": fwd_launches, f"{label} training path": train_launches}
    for mode, eng in modes.items():
        _build.reset_launches()
        step_m = eng.loss_and_grad(params, tree_batch)
        drives[f"{label} {mode} step"] = _build.launches()
        expect(f"tree step, bwd_mode=\"{mode}\"", drives[f"{label} {mode} step"], step_want(mode))
        check_step(f"{label} training tree, bwd_mode=\"{mode}\" vs \"cached\"", step_m, step_tree)
        del step_m
    del step_tree
    check_step(f"{label} training small input, kernel path vs reference path",
               engine.loss_and_grad(params, engine.prepare(small_trie)),
               ref_engine.loss_and_grad(params, ref_engine.prepare(small_trie)))

    # ---- timings in turns, memory, a profile
    (t_fwd, d_fwd), fwd_turns = turns_ms(lambda: engine.forward(params, tree_batch),
                                         lambda: engine.forward(params, dense_batch), rounds=2)
    (t_step, d_step), step_turns = turns_ms(lambda: engine.loss_and_grad(params, tree_batch),
                                            lambda: engine.loss_and_grad(params, dense_batch), rounds=2)
    log(f"{label} forward, in turns (medians of 2): tree {t_fwd:.2f} ms, dense {d_fwd:.2f} ms "
        f"(speedup {d_fwd / t_fwd:.3f}), dense-equivalent tokens/s tree {n_dense_tokens / t_fwd * 1e3:.1f}, "
        f"dense {n_dense_tokens / d_fwd * 1e3:.1f}; max_memory_allocated {fwd_peak:.3f} GiB; tree "
        + " ".join(f"{t:.2f}" for t in fwd_turns[0]) + ", dense " + " ".join(f"{t:.2f}" for t in fwd_turns[1]))
    log(f"{label} training step, in turns (medians of 2): tree {t_step:.2f} ms, dense {d_step:.2f} ms "
        f"(speedup {d_step / t_step:.3f}), dense-equivalent trained tokens/s tree "
        f"{n_dense_tokens / t_step * 1e3:.1f}, dense {n_dense_tokens / d_step * 1e3:.1f}; "
        f"max_memory_allocated over the tree + dense steps {train_peak:.3f} GiB (tree step {tree_peak:.3f}, "
        f"dense step {dense_peak:.3f}, the tree step's results alive); tree "
        + " ".join(f"{t:.2f}" for t in step_turns[0]) + ", dense " + " ".join(f"{t:.2f}" for t in step_turns[1]))
    step_engines = {"cached": engine, **modes}
    mode_t, mode_turns = turns_ms(*(lambda e=e: e.loss_and_grad(params, tree_batch)
                                    for e in step_engines.values()), rounds=2)
    log(f"{label} training step by backward mode, tree, in turns (medians of 2): "
        + ", ".join(f"{mode} {t:.2f} ms" for mode, t in zip(step_engines, mode_t)) + " ("
        + "; ".join(f"{mode} " + " ".join(f"{t:.2f}" for t in ts) for mode, ts in zip(step_engines, mode_turns))
        + ")")
    attn_bwd_class = {}
    for mode, eng in step_engines.items():
        layers_ = profile_run(lambda e=eng: e.loss_and_grad(params, tree_batch),
                              f"{label} tree training step, bwd_mode=\"{mode}\"")
        if not layers_:
            break
        attn_bwd_class[mode] = layers_.get(_kernel_layer("tree_attn_bwd"))
    log(f"{label} profile: attention-backward class of the tree step, device ms: "
        + ", ".join(f"{mode} {ms:.2f}" for mode, ms in attn_bwd_class.items()))
    return drives


def steps_ab(root: str) -> None:
    """``--steps-only [--root DIR]``: the tree training step in each backward
    mode, for MODEL and FAMILY_MODEL at full width (random weights from seed
    0) on the bench trie, from the port under `root` (this checkout by
    default; a checkout of another commit, to compare the two in one call):
    the steps of the three modes timed in turns (medians of 4, host clock,
    each synchronised) and the peak memory of each (max_memory_allocated
    over one step, the previous step's results freed). Uses only entry
    points both commits have; prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    dev = torch.device(DEVICE)
    seqs, attachs = synthetic_rollout_batch(
        seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
        completion_len=(128, 512), branch_prob=0.85,
    )
    out = {"root": root, "card": smi_line()}
    for name in (MODEL, FAMILY_MODEL):
        mc = MODEL_CONFIGS[name]
        params = init_params(mc, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
        engines = {mode: TreeEngine(mc, EngineConfig(bwd_mode=mode), device=dev)
                   for mode in ("cached", "split", "fused")}
        batch = engines["cached"].prepare(TokenTrie(seqs, attachs))
        peaks = {}
        for mode, eng in engines.items():
            eng.loss_and_grad(params, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eng.loss_and_grad(params, batch)
            torch.cuda.synchronize()
            peaks[mode] = torch.cuda.max_memory_allocated() / 2**30
        ms, runs = turns_ms(*(lambda e=e: e.loss_and_grad(params, batch) for e in engines.values()), warm=False)
        out[name] = {mode: {"ms": t, "turns_ms": r, "peak_gib": peaks[mode]}
                     for mode, t, r in zip(engines, ms, runs)}
        del params
    print(json.dumps(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    if "--steps-only" in sys.argv:
        steps_ab(sys.argv[sys.argv.index("--root") + 1] if "--root" in sys.argv else
                 os.path.dirname(os.path.abspath(__file__)))
        return 0
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
    from dynamictreeattn_tpu_torch.tries import (
        TokenTrie, build_block_meta, build_bwd_cache_sched, build_kmajor_work, build_qmajor_work,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: true fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t_run = t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase:.1f} s (run so far {now - t_run:.1f} s)")
        t_phase = now

    # ---- 1. build
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(_build.KERNEL_SOURCES)} "
        "(one nvcc per source, all at once)")
    for name, text in reports.items():
        for kernel, usage in ptxas_usage(text):
            log(f"  ptxas[{name}] {kernel}: {usage}")
            spill = re.search(r"(\d+) bytes spill stores", usage)
            if "qk_prep_bwd_kernel" in kernel and (spill is None or spill.group(1) != "0"):
                fail(f"ptxas: the qk-prep backward {kernel} spills or reports no spill line: {usage}")
        for line in text.splitlines():  # e.g. wgmma products serialised
            if "Potential Performance Loss" in line:
                log(f"  ptxas[{name}] {line.split('ptxas info    : ', 1)[-1]}")
                if name.startswith("lm_stats") or name == "tree_attn_bwd":
                    fail(f"ptxas serialised the wgmma products of {name}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    phase_done("1 (build)")

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

    # the host trie layer: prepare (flatten, pad, block metadata, the two
    # work lists, upload), and its parts; the slot schedule, which prepare
    # no longer builds on the card, alone
    prep_tree_ms, tree_batch = host_ms(lambda: engine.prepare(trie))
    prep_dense_ms, dense_batch = host_ms(lambda: engine.prepare(dense_packed))
    n = tree_batch.n_padded
    sched_ms, work_ms, qwork_ms = {}, {}, {}
    n_slots = ta.kmajor_slots(dev, mc.head_dim)
    for label, packed_ in (("tree", tree_batch.packed), ("dense", dense_batch.packed)):
        bm = build_block_meta(packed_.last_desc, ec.block_q, ec.block_kv)
        sched_ms[label], _ = host_ms(lambda: build_bwd_cache_sched(bm, bm.q_ids.shape[0]))
        sched_ms[label + " visits"] = int((bm.kv_types > 0).sum())
        work_ms[label], _ = host_ms(lambda: build_kmajor_work(
            packed_.last_desc, bm.q_ids, bm.q_counts, bm.q_types, ec.block_q, ec.block_kv,
            mc.num_key_value_heads, n_slots))
        qwork_ms[label], _ = host_ms(lambda: build_qmajor_work(
            packed_.last_desc, bm.kv_ids, bm.kv_counts, bm.kv_types, ec.block_q, ec.block_kv))
    log(f"workload: {len(seqs)} seqs, {n_dense_tokens} dense tokens, sharing "
        f"{sharing_ratio(seqs):.4f}, tree {tree_batch.packed.n_tokens} -> padded {n}, "
        f"dense padded {dense_batch.n_padded}, blocks {ec.block_q}/{ec.block_kv}")
    log(f"host prepare (median of 3, host clock): tree {prep_tree_ms:.2f} ms (from the TokenTrie: "
        f"flatten, pad, block metadata, K1/K2/K11 and K3/K10/K12 work lists, upload; no slot schedule), "
        f"dense {prep_dense_ms:.2f} ms (from the packed dense forest); build_bwd_cache_sched alone (built "
        f"for the plain K3 only): tree {sched_ms['tree']:.2f} ms over {sched_ms['tree visits']} visits, "
        f"dense {sched_ms['dense']:.2f} ms over {sched_ms['dense visits']} visits; build_kmajor_work alone ({mc.num_key_value_heads} kv heads, {n_slots} chunk slots): tree "
        f"{work_ms['tree']:.2f} ms, dense {work_ms['dense']:.2f} ms; build_qmajor_work alone: tree "
        f"{qwork_ms['tree']:.2f} ms, dense {qwork_ms['dense']:.2f} ms")
    if len(tree_batch.meta) != 6 or len(dense_batch.meta) != 6:
        fail("prepare built a slot schedule on the card, where K3 takes none")
    for eng_ in (engine, *mode_engines.values()):
        if not (eng_._wants_kmajor_work() and eng_._wants_qmajor_work()) or eng_._wants_schedule():
            fail(f"bwd_mode={eng_.cfg.bwd_mode!r}: prepare would not build both work lists and no schedule")
    if tree_batch.kmajor_work is None or dense_batch.kmajor_work is None:
        fail("prepare built no key-major work list for K3/K10/K12")
    if tree_batch.qmajor_work is None or dense_batch.qmajor_work is None:
        fail("prepare built no query-major work list for K1/K2/K11")

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
        meta = (*tree_batch.meta, *plain_schedule(tree_batch, ec))  # the schedule for the plain K3
        ld = tree_batch.last_desc
        bq, bkv = ec.block_q, ec.block_kv
        c = ta._score_bound(q4, k, scale)
        c_max = float(c.max())
        if not c_max < ta.BOUND_SAFE_MAX:
            fail(f"layer-0 bound max(C)={c_max:.2f} should be < {ta.BOUND_SAFE_MAX} (qk-norm)")
        attn_args = (ld, *meta[:3], scale, bq, bkv)
        qwork = tree_batch.qmajor_work
        o1, lse1 = ta.tree_attn_fwd_bound(q4, k, v, *attn_args, c, work=qwork)
        o1p, lse1p = ta.tree_attn_fwd_plain(q4, k, v, *attn_args, c=c)
        o2, lse2 = ta.tree_attn_fwd_online(q4, k, v, *attn_args, work=qwork)
        o2p, lse2p = ta.tree_attn_fwd_plain(q4, k, v, *attn_args)
        again = (*ta.tree_attn_fwd_bound(q4, k, v, *attn_args, c, work=qwork),
                 *ta.tree_attn_fwd_online(q4, k, v, *attn_args, work=qwork))
        torch.cuda.synchronize()
        if not all(torch.equal(a_, b_) for a_, b_ in zip((o1, lse1, o2, lse2), again)):
            fail("K1/K2: two launches on the same inputs differ (the forward has no atomics)")
        errs = {
            "K1 o": check_close("K1 o", o1, o1p, ATTN_O_ATOL, ATTN_O_RTOL),
            "K1 lse": check_close("K1 lse", lse1, lse1p, ATTN_LSE_ATOL),
            "K2 o": check_close("K2 o", o2, o2p, ATTN_O_ATOL, ATTN_O_RTOL),
            "K2 lse": check_close("K2 lse", lse2, lse2p, ATTN_LSE_ATOL),
            "K1 vs K2 o": check_close("K1 vs K2 o", o1, o2, ATTN_O_ATOL, ATTN_O_RTOL),
        }
        log(f"K1/K2 at q4 {tuple(q4.shape)} through the work list ({qwork_stats(qwork, hq // hkv, hkv)}), "
            f"max C {c_max:.3f}: "
            + ", ".join(f"{key} max|err| {val:.3e}" for key, val in errs.items())
            + f" (o tol {ATTN_O_ATOL}+{ATTN_O_RTOL}*|ref|: bf16 output spacing, other summation "
              f"order and P rounding points; lse tol {ATTN_LSE_ATOL}: fp32 sums); two launches bit-equal")
        check_qwork_bugs(ta, "Qwen3-0.6B layer 0", q4, k, ld, meta, c, qwork, scale, bq, bkv)
        # both branches of the bound dispatch, chosen on the card and read
        # from the kernel's branch record: the real inputs take K1; q scaled
        # by a power of two (exact in bf16) that pushes max(C) past 40 must
        # take K2
        big = 2.0 ** math.ceil(math.log2(ta.BOUND_SAFE_MAX / c_max))
        for label, qq, want in (("max(C) < 40", q4, "tree_attn_fwd_bound"),
                                (f"q*{big:g}, max(C) >= 40", q4 * big, "tree_attn_fwd_online")):
            _build.reset_launches()
            od, lsed = ta._fwd_dispatch(qq, k, v, ld, *meta[:3], scale, ta.BlockSizes(bq, bkv), "bound",
                                        qwork)
            moved = [key for key, val in _build.launches().items() if val]
            if moved != [want] or _build.fwd_branches() != [want]:
                fail(f"dispatch with {label} launched {moved} (record {_build.fwd_branches()}), "
                     f"expected [{want}]")
            op, lsep = ta.tree_attn_fwd_plain(qq, k, v, *attn_args)
            e_o = check_close(f"dispatch {label} o", od, op, ATTN_O_ATOL, ATTN_O_RTOL)
            e_l = check_close(f"dispatch {label} lse", lsed, lsep, ATTN_LSE_ATOL)
            log(f"dispatch {label}: took {want}, o max|err| {e_o:.3e}, lse max|err| {e_l:.3e}")

        # the three backward modes on the same q/k/v, with a seeded output
        # cotangent, (o, lse) from K1 and from K2; the work lists are the
        # ones prepare built, the plain K3's slot schedule R = every kv block
        # (no eviction)
        gen = torch.Generator(device=dev).manual_seed(1)
        do = torch.randn(q4.shape, generator=gen, device=dev).to(torch.bfloat16)
        mode_ids = {"cached": "K3", "fused": "K10", "split": "K11/K12"}
        bwd_errs = {mode: {} for mode in BWD_KERNELS}  # mode -> {dq|dk|dv: max|err|}
        bwd_repeat = {}
        for mode, kid in mode_ids.items():
            for label, o_, lse_ in ((f"{kid} with K1's lse", o1, lse1), (f"{kid} with K2's lse", o2, lse2)):
                errs_b, _, rep = check_attention_bwd(ta, mode, label, q4, k, v, ld, meta, o_, lse_, do,
                                                     scale, bq, bkv, work=tree_batch.kmajor_work, qwork=qwork)
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
        log("run to run (K11, K12 and the dk/dv of K3 and K10 sum in a fixed order and must repeat "
            "bit-equal; the dq of K3 and K10 (bulk reduce-add) sums in no fixed order, no bar): "
            + ", ".join(f"{mode_ids[m]} {key} {val:.3e}" for (m, key), val in bwd_repeat.items()))
        # the work list at (128, 2): its stats, and the planted bugs through the kernels
        kwork = tree_batch.kmajor_work
        log(f"K3/K10/K12 work list at Qwen3-0.6B (dh {dh}, group {hq // hkv}, {hkv} kv heads), n={n}: "
            f"{work_stats(kwork, hq // hkv, hkv, dh, torch.cuda.get_device_properties(dev).multi_processor_count)}")
        tail2 = (do, lse2, torch.sum(do.float() * o2.float(), dim=-1), scale, bq, bkv)
        ref_dkv = ta.tree_attn_bwd_dkv_plain(q4, k, v, ld, *meta[3:6], *tail2)
        check_work_bugs(ta, "Qwen3-0.6B layer 0 with K2's lse", q4, k, v, ld, meta, tail2, kwork, ref_dkv)
        check_qwork_dq_bugs(ta, "Qwen3-0.6B layer 0 with K2's lse", q4, k, ld, meta, lse2, qwork, scale, bq, bkv)
        # what the wrappers refuse on the card: no work list (no per-call
        # build), and one built for another length (out-of-range tiles)
        half = [a[:a.shape[0] // 2] for a in meta[:6]]
        others = {"k": ta.kmajor_work(ld[:n // 2], *half[3:6], bq, bkv, hkv, dh, dev),
                  "q": ta.qmajor_work(ld[:n // 2], *half[:3], bq, bkv, dev)}
        for fn, meta_, kind in ((ta.tree_attn_bwd_dkv, meta[3:6], "k"),
                                (ta.tree_attn_bwd_cached, (*meta[:6], None, None), "k"),
                                (ta.tree_attn_bwd_fused, meta[:3], "k"), (ta.tree_attn_bwd_dq, meta[:3], "q")):
            for what, w_ in (("no work list", None), (f"a work list of {others[kind].n_tiles} tiles",
                                                      others[kind])):
                try:
                    fn(q4, k, v, ld, *meta_, *tail2, work=w_)
                except ValueError as err:
                    log(f"{fn.__name__} with {what} refused: {err}")
                else:
                    fail(f"{fn.__name__} ran with {what} at n={n}")

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
                                          bq, bkv, ta._score_bound(qa4, ka, scale), work=adv_batch.qmajor_work)
        doa = torch.randn(qa4.shape, generator=gen, device=dev).to(torch.bfloat16)
        dia = torch.sum(doa.float() * oa.float(), dim=-1)
        adv_meta = (*adv_batch.meta, *plain_schedule(adv_batch, ec))
        for mode, kid in mode_ids.items():
            errs_a, refs_a, _ = check_attention_bwd(ta, mode, f"{kid} adversarial", qa4, ka, va,
                                                    adv_batch.last_desc, adv_meta, oa, lsea, doa,
                                                    scale, bq, bkv, work=adv_batch.kmajor_work,
                                                    qwork=adv_batch.qmajor_work)
            for key, val in errs_a.items():
                bwd_errs[mode][key] = max(bwd_errs[mode][key], val)
            for how in ("drop", "unmask"):
                got = attention_bwd(ta, mode, qa4, ka, va, adv_batch.last_desc,
                                    mutated_meta(adv_meta, how), doa, lsea, dia, scale, bq, bkv,
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
            if label == qk_cases[0][0] or not use_norm:
                # K6 / K7: one launch a call, dw summed on the card
                bwd_calls = {"qk_prep_bwd_q": lambda: qp.qk_prep_bwd_q(cts[0], q_, qw_, cos_, sin_, eps, use_norm),
                             "qk_prep_bwd_kv": lambda: qp.qk_prep_bwd_kv(cts[1], cts[2], k_, kw_, cos_, sin_, eps,
                                                                         use_norm)}
                for kname, call in bwd_calls.items():
                    names = device_kernels(call)
                    if len(names) != 1 or "qk_prep_bwd_kernel" not in names[0]:
                        fail(f"{kname} {label}: one call launched {names}, expected one qk_prep_bwd_kernel")
                log(f"K6/K7 {label}: each call traced as one launch of qk_prep_bwd_kernel")
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
        g_lse = torch.randn(n, generator=gen, device=dev)
        g_ent = torch.randn(n, generator=gen, device=dev)
        lm_errs = lm_head_checks(hidden, w_lm, g_lse, g_ent)

    phase_done("2 (Qwen3-0.6B kernels vs plain)")
    # ---- 2b. the tree-attention kernels at every (head_dim, group) pair
    shape_rows = shapes_phase(ta, engine, {"bench": trie, "small": TokenTrie(seqs[:4], attachs[:4])}, flush)
    phase_done("2b (tree-attention kernels at every dense (head_dim, group))")

    # ---- 3. forward path: counts from 0, drive, read
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    lp_tree = engine.forward(params, tree_batch)
    lp_dense = engine.forward(params, dense_batch)
    lp_online = online_engine.forward(params, tree_batch)
    launches = _build.launches()
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

    if set(lp_tree) != set(range(len(seqs))) or any(
            lp_tree[bid].shape != (len(seq) - 1,) for bid, seq in enumerate(seqs)):
        fail("tree forward: per-sequence ids or log-prob vector shapes differ from the batch's")
    check_logprobs("tree vs dense", lp_tree, lp_dense)
    check_logprobs("bound vs online engine, tree", lp_tree, lp_online)
    # the fused qk-prep path against the unfused one on the tree batch (the
    # unfused chain rounds the normed q/k to bf16 before RoPE: <= 1 ulp)
    check_logprobs("fused vs unfused qk-prep, tree forward", lp_tree,
                   unfused_engine.forward(params, tree_batch))

    # a reference on a small input: 4 sequences cut to 192 tokens, kernel
    # path vs dense-mask reference attention + plain vocab fold
    ref_engine = TreeEngine(mc, dataclasses.replace(ec, attn_backend="reference", loss_mode="vocab"),
                            device=dev)
    small_trie = TokenTrie([s_[:192] for s_ in seqs[:4]], attachs[:4])
    check_small_forward("small input", engine, ref_engine, params, small_trie)

    phase_done("3 (Qwen3-0.6B forward path)")
    # ---- 4. training path. First one layer's attention, forward and
    # backward, as the engine's default config runs it, under the sync
    # debug mode that raises on any host synchronisation
    del lp_tree, lp_dense, lp_online
    leaves = [t.clone().requires_grad_() for t in (q4.reshape(hq, n, dh), k, v)]  # out of inference mode
    do_l = torch.randn(leaves[0].shape, generator=gen, device=dev).to(torch.bfloat16)
    attn = engine._attn_fn(tree_batch)
    torch.autograd.grad(attn(*leaves), leaves, do_l)  # warm: the libraries loaded, the record made
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads_l = torch.autograd.grad(attn(*leaves), leaves, do_l)
    except RuntimeError as err:
        fail(f"one layer's tree attention (forward + backward) synchronised with the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    one_layer = {key: val for key, val in _build.launches().items() if val}
    if not all(torch.isfinite(g_.float()).all() for g_ in grads_l):
        fail("one layer's attention gradients are not finite")
    if one_layer != {"tree_attn_fwd_bound": 1, "tree_attn_bwd_cached": 1}:
        fail(f"one layer's attention launched {one_layer}, expected one K1 and one K3")
    log(f"one layer's tree_attention forward + backward (the engine's default config: softmax "
        f"{ec.fwd_softmax!r}, backward \"auto\") under torch.cuda.set_sync_debug_mode(\"error\"): no host "
        f"synchronisation; launches {one_layer}")

    # the step: counts from 0, drive, read; which forward branch each
    # tree-attention launch took, in launch order, from the device record
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_tree = engine.loss_and_grad(params, tree_batch)
    tree_counts, tree_branches = _build.launches(), _build.fwd_branches()
    tree_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    step_dense = engine.loss_and_grad(params, dense_batch)
    train_launches = _build.launches()
    dense_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    train_peak_gib = max(tree_peak_gib, dense_peak_gib)
    log(f"training path launches (tree step + dense step): {train_launches}; tree step alone: "
        f"{tree_counts}")
    missing = [key for key in TRAIN_KERNELS if train_launches[key] == 0]
    if missing:
        fail(f"kernels never launched on the training path: {missing}")
    per_step = step_counts("cached", L)
    for label, counts, steps in (("tree step", tree_counts, 1), ("both steps", train_launches, 2)):
        got = counted(counts, per_step)
        if got != {key: steps * val for key, val in per_step.items()}:
            fail(f"{label}: launch counts {got}, expected {steps} x {per_step} (28 layers under remat: "
                 "forward + recompute, one backward, K3 only)")
    if len(tree_branches) != 2 * L or tree_branches[L:] != tree_branches[:L][::-1]:
        fail(f"the remat recompute did not take each layer's forward branch: {tree_branches}")
    log(f"remat: each of the {L} recomputed layers took its forward's branch, read from the device record "
        f"({sum(b == 'tree_attn_fwd_bound' for b in tree_branches[:L])} bound, "
        f"{sum(b == 'tree_attn_fwd_online' for b in tree_branches[:L])} online in the tree step)")

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
        mode_launches[mode] = _build.launches()
        want = step_counts(mode, L)
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

    phase_done("4 (Qwen3-0.6B training path)")
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
        f"max_memory_allocated over the tree + dense steps {train_peak_gib:.3f} GiB (tree step "
        f"{tree_peak_gib:.3f}, dense step {dense_peak_gib:.3f}, the tree step's results alive)")
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

    kernels = []
    lib_fwd_ms, lib_bwd_ms = sdpa_ms(q4, k, v, ld, do, scale, flush)
    with torch.inference_mode():
        for name, kid, line, bound_c, err in (
            ("tree_attn_fwd_bound", "K1", 248, c, max(errs["K1 o"], errs["K1 lse"])),
            ("tree_attn_fwd_online", "K2", 80, None, max(errs["K2 o"], errs["K2 lse"])),
        ):
            if bound_c is not None:
                run = lambda: ta.tree_attn_fwd_bound(q4, k, v, *attn_args, bound_c, work=qwork)  # noqa: E731
                plain = lambda: ta.tree_attn_fwd_plain(q4, k, v, *attn_args, c=bound_c)  # noqa: E731
            else:
                run = lambda: ta.tree_attn_fwd_online(q4, k, v, *attn_args, work=qwork)  # noqa: E731
                plain = lambda: ta.tree_attn_fwd_plain(q4, k, v, *attn_args)  # noqa: E731
            flops, nbytes = attention_work(ld, hq, hkv, dh, n, bound_c is not None)
            b_ms, b_by = bound_ms(flops, nbytes)
            k_ms = cuda_ms(run, 20, flush)
            kernels.append({
                "name": name, "id": kid, "route": "cuda",
                "source": "dynamictreeattn_tpu_torch/csrc/tree_attn_fwd.cu",
                "replaces": f"dynamictreeattn_tpu/ops/tree_attention.py:{line}",
                "launches": launches[name], "max_abs_err": err,
                "ms": k_ms, "plain_ms": cuda_ms(plain, 2, flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_fwd_ms,
                "library_call": "SDPA forward, dense bool mask",
                "bound_fraction": b_ms / k_ms,
            })

    # the backward kernels, at the same inputs as their checks (K1's lse)
    di1 = torch.sum(do.float() * o1.float(), dim=-1)
    with torch.inference_mode():
        bwd_args = (q4, k, v, ld)
        tail = (do, lse1, di1, scale, bq, bkv)
        split_errs = bwd_errs["split"]
        work_kw = {"work": tree_batch.kmajor_work}
        for name, kid, line, kind, fn, plain, meta_, kw_, source, err in (
            ("tree_attn_bwd_dq", "K11", 431, "dq", ta.tree_attn_bwd_dq, ta.tree_attn_bwd_dq_plain,
             meta[:3], {"work": qwork}, "tree_attn_bwd.cu", split_errs["dq"]),
            ("tree_attn_bwd_dkv", "K12", 568, "dkv", ta.tree_attn_bwd_dkv, ta.tree_attn_bwd_dkv_plain,
             meta[3:6], work_kw, "tree_attn_bwd_kmajor.cu", max(split_errs["dk"], split_errs["dv"])),
        ):
            b_ms, b_by = bound_ms(*attention_bwd_work(ld, hq, hkv, dh, n, kind))
            k_ms = cuda_ms(lambda: fn(*bwd_args, *meta_, *tail, **kw_), 20, flush)
            kernels.append({
                "name": name, "id": kid, "route": "cuda",
                "source": f"dynamictreeattn_tpu_torch/csrc/{source}",
                "replaces": f"dynamictreeattn_tpu/ops/tree_attention.py:{line}",
                "launches": 0, "max_abs_err": err, "ms": k_ms,
                "plain_ms": cuda_ms(lambda: plain(*bwd_args, *meta_, *tail), 2, flush),
                "bound_ms": b_ms, "bound_by": b_by, "bound_fraction": b_ms / k_ms, "library_ms": lib_bwd_ms,
                "library_call": "SDPA backward (dq, dk, dv), dense bool mask: one time for the "
                                "K11+K12 pair",
            })
        # K3 and K10: ms of the wrapper (fp32 scratch zeroed, the kernel, the
        # cast of the scratch to bf16), as the step runs it
        for name, kid, line, mode in (("tree_attn_bwd_cached", "K3", 1032, "cached"),
                                      ("tree_attn_bwd_fused", "K10", 715, "fused")):
            b_ms, b_by = bound_ms(*attention_bwd_work(ld, hq, hkv, dh, n, "fused"))
            k_ms = cuda_ms(lambda: attention_bwd(ta, mode, *bwd_args, meta, *tail, **work_kw), 20, flush)
            kernels.append({
                "name": name, "id": kid, "route": "cuda",
                "source": "dynamictreeattn_tpu_torch/csrc/tree_attn_bwd_kmajor.cu",
                "replaces": f"dynamictreeattn_tpu/ops/tree_attention.py:{line}",
                "launches": 0, "max_abs_err": max(bwd_errs[mode].values()), "ms": k_ms,
                "bound_fraction": b_ms / k_ms,
                "plain_ms": cuda_ms(lambda: attention_bwd(ta, mode, *bwd_args, meta, *tail, plain=True),
                                    2, flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_bwd_ms,
                "library_call": "SDPA backward (dq, dk, dv), dense bool mask",
                "run_to_run_max_abs": max(bwd_repeat[mode, key] for key in ("dq", "dk", "dv")),
            })

        kernels += lm_head_rows(hidden, w_lm, g_lse, g_ent, flush, errs=lm_errs)
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
                "ms_clean_l2": cuda_ms(lambda: qk_calls[name](kfn), 20, flush, clean=True),
                "plain_ms": cuda_ms(lambda: qk_calls[name](pfn), 5, flush),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library_call": "none: no single PyTorch call computes per-head RMSNorm + RoPE + "
                                "the head-major transpose",
            })
        # a streaming yardstick for K6, not its function: one PyTorch add of
        # two [n, hq*dh] bf16 tensors into a third (K6's activation bytes,
        # without its transposed read, cos/sin and dw)
        g_flat, out_flat = gq_.reshape(q_.shape), torch.empty_like(q_)
        stream_ms = cuda_ms(lambda: torch.add(g_flat, q_, out=out_flat), 20, flush)
        next(kd for kd in kernels if kd["name"] == "qk_prep_bwd_q")["stream_yardstick_ms"] = stream_ms
        del g_flat, out_flat
    phase_done("5 (Qwen3-0.6B timings, profiles, kernel rows)")
    # ---- 6. the sampler path (K13)
    k13_row, sampler_launches = sampler_phase(params, mc, dev, engine, flush)
    kernels.append(k13_row)
    phase_done("6 (sampler)")
    # ---- 7. the second family at full width
    family_drives = family_phase(seqs, attachs, dev)
    # K8 / K9 at the family's hidden size: random bf16 inputs at the bench
    # trie's n, the head scaled as init_params scales it
    fmc = MODEL_CONFIGS[FAMILY_MODEL]
    gen = torch.Generator(device=dev).manual_seed(5)
    h15 = torch.randn(n, fmc.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
    w15 = (torch.randn(fmc.vocab_size, fmc.hidden_size, generator=gen, device=dev)
           * fmc.hidden_size**-0.5).to(torch.bfloat16).t()
    kernels += lm_head_rows(h15, w15, *torch.randn(2, n, generator=gen, device=dev), flush, config=FAMILY_MODEL)
    del h15, w15
    kernels += qk_bwd_family_rows(tree_batch.depth, flush)
    phase_done(f"7 ({FAMILY_MODEL} forward and training paths, K8/K9 at its hidden size)")

    # launches over the drives, each from counts of 0: the forward path, the
    # training path (tree + dense step, default backward), the tree step in
    # each other backward mode, the sampler (one sampled rollout), and the
    # same four training drives of the second family. A row at another
    # shape ("name@config") counts the drives of its config only.
    drives = {"forward path": launches, "training path": train_launches,
              "split step": mode_launches["split"], "fused step": mode_launches["fused"],
              "sampler": sampler_launches, **family_drives}
    kernels += shape_rows
    for kd in kernels:
        base, _, config = kd["name"].partition("@")
        kd["launches_by_drive"] = {drive: counts[base] for drive, counts in drives.items()
                                   if not config or drive.startswith(config + " ")}
        kd["launches"] = sum(kd["launches_by_drive"].values())
    for kd in kernels:
        lib_ms = "none" if kd["library_ms"] is None else f"{kd['library_ms']:.3f} ms"
        log(f"{kd['id']} {kd['name']}: {kd['ms']:.4f} ms (bound {kd['bound_ms']:.4f} ms by "
            f"{kd['bound_by']}, plain {kd['plain_ms']:.2f} ms, library {lib_ms}), "
            f"{kd['launches']} launches ("
            + ", ".join(f"{drive} {c}" for drive, c in kd["launches_by_drive"].items() if c) + ")")

    for kd in kernels:
        if kd["id"] not in ("K1", "K2"):
            continue
        shape = kd.get("shape", {"config": MODEL, "head_dim": mc.head_dim,
                                 "group": mc.num_attention_heads // mc.num_key_value_heads})
        parent = FWD_PARENT_MS.get((shape["head_dim"], shape["group"]))
        if parent is not None:
            old = parent[kd["id"] == "K2"]
            log(f"{kd['id']} at {shape['config']} (dh {shape['head_dim']}, group {shape['group']}): "
                f"{kd['ms']:.4f} ms; the parent kernel {old:.4f} ms (recorded in PERF.md, not "
                f"measured here: x{old / kd['ms']:.2f}); bound {kd['bound_ms']:.4f} ms, "
                f"{kd['bound_fraction']:.3f} of it reached; SDPA {kd['library_ms']:.4f} ms")
    for kd in kernels:
        if kd["id"] not in ("K11", "K10"):
            continue
        shape = kd.get("shape", {"config": MODEL, "head_dim": mc.head_dim,
                                 "group": mc.num_attention_heads // mc.num_key_value_heads})
        old = BWD_PARENT_MS[shape["head_dim"], shape["group"]][kd["id"] == "K10"]
        k3 = next(x["ms"] for x in kernels if x["id"] == "K3" and x.get("shape") == kd.get("shape"))
        log(f"{kd['id']} at {shape['config']} (dh {shape['head_dim']}, group {shape['group']}): "
            f"{kd['ms']:.4f} ms; the parent kernel {old:.4f} ms (recorded in PERF.md, not measured here: "
            f"x{old / kd['ms']:.2f}); bound {kd['bound_ms']:.4f} ms, {kd['bound_fraction']:.3f} of it "
            f"reached; K3 at the same shape {k3:.4f} ms ({kd['ms'] / k3:.3f} of it)")
    for kd in kernels:
        if kd["name"] in QK_PARENT_MS:
            old = QK_PARENT_MS[kd["name"]]
            stream = kd.get("stream_yardstick_ms")
            log(f"{kd['id']} {kd['name']}: {kd['ms']:.4f} ms; the two-launch kernel {old:.4f} ms (recorded in "
                f"PERF.md, not measured here: x{old / kd['ms']:.2f}); bound {kd['bound_ms']:.4f} ms, "
                f"{kd['bound_ms'] / kd['ms']:.3f} of it reached; {kd['ms_clean_l2']:.4f} ms with the L2 left "
                "clean" + ("" if stream is None else
                           f"; a PyTorch add of two [n, hq*dh] bf16 tensors {stream:.4f} ms (same timing)"))
    for kd in kernels:
        if kd["name"] in LM_PARENT_MS:
            old = LM_PARENT_MS[kd["name"]]
            log(f"{kd['id']} {kd['name']}: {kd['ms']:.4f} ms; the parent kernel {old:.4f} ms (recorded in "
                f"PERF.md, not measured here: x{old / kd['ms']:.2f}); bound {kd['bound_ms']:.4f} ms, "
                f"{kd['bound_fraction']:.3f} of it reached; chunked library loop {kd['library_ms']:.4f} ms; "
                f"the bare products in cuBLAS {kd['products_ms']:.4f} ms")
    log(f"run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
