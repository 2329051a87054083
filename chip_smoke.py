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
   (``qk_bwd_family_rows``);
8. the RL loop and the grad-parity protocol (``rl_phase``), Qwen3-0.6B at
   full width: ``TreeEngine.loss_and_grad_custom`` on the bench trie (a
   linear per-sequence loss against ``loss_and_grad``, the GRPO loss tree
   against dense, the exact launches of one custom step, two
   ``bwd_mode="split"`` custom steps bit-equal, the custom step against
   ``loss_and_grad`` in turns); ``examples.rl_loop.main`` for 3 iterations
   at the sampler's widths (2 prompts of 1536 tokens x 16, 384 new
   tokens), each rollout, behavior forward and custom step counted on its
   own (exactly 28 x 383 K13 per rollout), and on iteration 1's batch a
   custom step's summed completion log-probs against
   ``TreeEngine.forward``'s; then the grad-parity protocol through
   ``cli.run`` (tree and dense backward on ``data/synthetic-tau2/call0.npz``
   with ``--grad-out`` into a temporary directory) and
   ``cli.compare_grads``, its table's max rel within the bar;
9. the single-card trainer (``trainer_phase``), Qwen3-0.6B at full width
   on the bench trie: one training step per remat setting (off, policies
   None, "attn", "dots", "attn_dots", None and "attn" with 4 nested
   segments) with exact launch counts from 0 (K1 once per layer under
   "attn"), the first step's loss bit-equal across settings, grads against
   None's within 4x the spread of two None steps, every setting bit-equal
   to None under the split backward, and each setting's step ms in turns,
   peak memory and K1 class; ``Trainer`` (policy "attn", clip, warmup) for
   3 steps, its first loss bit-equal to ``loss_and_grad``'s, descending,
   one host synchronisation a step, the split of a step (engine, clip,
   AdamW, the read) and the host ms of its ``prepare_step``; ``cli.train`` 2 steps + a resumed step bit-equal to 3 steps, the
   checkpoint restored bit-equal, its save and restore seconds; and one
   Qwen3-4B trainer step with full recompute and with 6 nested segments
   (peak memory, step ms);
10. the Qwen3-MoE family (``moe_phase``) at Qwen3-30B-A3B's full width
   (MOE_MODEL: d=2048, 32 q / 4 kv heads, group 8, 128 experts, top-8,
   expert width 768, V=151936 untied, bf16, random weights from seed 0),
   each part with its ms, device busy, peak memory, kernel launches by id
   from 0, the (row, choice) pairs dropped past capacity per layer and the
   load-balance loss: (a) the scoring forward at all 48 layers on the bench
   trie, tree vs dense per-token log-probs at capacity factor E/k (capacity
   = n, so nothing can drop; the dense replay in chunks of whole sequences)
   with zero drops, the dense side's top-k choices held against the tree's
   (``moe_routing``: the share that flips, and how far from a near-tie),
   then the default factor timed in turns; (c) the GRPO
   rollout at 48 layers (the sampler phase's prompts) through the replayed
   decode step (one capture, 48 K13 launches a step), replayed greedy
   tokens equal to the eager loop's, the decode step's host ms against its
   busy ms and the floor of reading every expert once; (b) the training
   step: tree vs dense at factor E/k without the load-balance term
   (MOE_PARITY_LAYERS layers, the dense grads summed over chunks in fp32),
   two ``bwd_mode="split"`` steps bit-equal, one MoE layer forward +
   backward under ``torch.cuda.set_sync_debug_mode("error")``, and the
   default step at MOE_STEP_LAYERS layers (exact launches, finite loss,
   router and expert grads non-zero, tree and dense in turns); (d)
   ``Trainer`` 3 steps at MOE_TRAINER_LAYERS layers, one host read a step;
   (e) the HF bridge: MOE_HF_LAYERS layers written as safetensors shards by
   this script's own writer, loaded through ``load_hf_checkpoint``
   bit-equal, and ``cli.run --ckpt`` equal to the run on the same weights in
   memory; then K8 and K9 at its hidden size and untied head. Phase 2b runs
   the tree-attention kernels at its (head_dim, group) = (128, 8) on the
   bench trie;
10b. the optimizer layer (``adamw_phase``) at the leaves of ADAMW_CONFIGS
   (Qwen3-0.6B, and Qwen3-30B-A3B at 8 layers: 5.61 B parameters, 45 GB of
   params, grads and moments), bf16 values seeded leaf by leaf: the sum of
   squares (A2) twice bit-equal and within ADAMW_NORM_REL of the eager fp32
   norm (an fp64 sum printed beside it); the update (A1), all leaves in one
   launch, bit-equal leaf by leaf to the plain version (each leaf redrawn
   from its seed) given the same clip factors, the grads unchanged; the
   kernels and ``OptaxAdamW.update`` timed with CUDA events against the
   byte bound (16 bytes a parameter at 3.35 TB/s: A1 14, A2 2) and the
   plain versions; and the launches of one ``Trainer`` step at Qwen3-0.6B
   (exactly one A1 and two A2: the partials and their sum) and its host
   synchronisations (exactly one, the step's read);
10c. latent attention (``mla_phase``) at Moonlight-16B-A3B's widths (q/k
   192, v 128, group 1, 16 heads) on the two-prompt GRPO trie: K1/K2 and
   K3/K10 against their plain versions, two launches of each (K2 and K3's
   dk/dv bit-equal), K11/K12 refused, each timed beside its bound; then one
   ``Trainer`` step at its first MLA_LAYERS layers with launches counted from
   0 after a warm step (K3 once a layer, one A1, two A2, K1/K2 at least
   once a layer);
11. data, tensor, vocab and expert parallelism over torch.distributed
   (``parallel_phase``): K8 / K9 against their plain versions on the
   vocabulary shard of tp = 2 (75,968 columns, the last 256-column tile
   ragged); then PARALLEL_WORLD ranks, fresh processes of this script
   (``--parallel-rank``, ``parallel_rank``) sharing the one card over gloo
   with CUDA tensors (NCCL refuses two ranks of one communicator on one
   device, so its branch runs nowhere here), each printing its checks.
   Every reference is the one-device steps on the bins, run by each rank
   and summed in rank order, so it needs no collective of its own. (a) dp
   = 2 on the bench trie in two bins by token count, bwd_mode "split"
   bit-equal (loss and every grad) to the two one-device steps on the bins
   summed, "auto" within phase 4's bars, each rank launching what its
   bin's one-device step launches; (b) tp = 2 and dp = 2 x tp = 2 against
   the one-device step (its shards), K8 / K9 on the 75,968-row shard, K1-K7
   on 8 q / 4 kv local heads with work lists built for them, one TP layer
   forward and backward under ``torch.cuda.set_sync_debug_mode("error")``
   outside its collectives; (d) ``cli.train --dp 2 --tp 2`` in the ranks'
   process group (it joins it, as under ``torchrun``) for 2 steps, saving
   a checkpoint that a one-device restore, cut again into each rank's
   shards, reproduces bit for bit; (c) ep = 2 at Qwen3-30B-A3B's width and
   MOE_PARITY_LAYERS layers (64 of the 128 experts a rank): at factor E/k
   no drops, the routing against the one-device step's (flips gated as
   phase 10's own routing), loss and grads within phase 4's bars (the
   router's and the experts' too when no choice flipped on either rank);
   at 1.5 the drops per block at the dispatch and at the experts, finite
   loss, expert grads non-zero, the all-to-all bytes a block; (e) each
   rank's step and collective ms, labelled as ranks sharing one card (no
   scaling number). Then in the parent (d) goes on: its step 1 against
   ``cli.train --dp 1``, and its checkpoint resumed at ``--dp 1``. Which
   collectives gloo takes on CUDA tensors was probed once (PERF.md,
   Findings); the ranks use those alone.

12. ZeRO-3 (FSDP) and sequence parallelism, Ulysses and ring (``sp_phase``):
   first, in the parent, K2, K11 and K12 with position offsets against
   their plain versions at every live (q shard, kv shard) pair of the
   sp = 4 ring layout of the bench trie (Qwen3-0.6B's head layout, random
   bf16 inputs; K11 / K12 from the whole sequence's lse; rows that see no
   key of a pair must do so in both versions), each pair's ms, the empty
   pairs counted (``ring_pair_checks``); then SP_WORLD ranks, fresh
   processes of this script (``--sp-rank``, ``sp_rank``) over gloo on the
   one card, Qwen3-0.6B at 28 layers on the bench trie: (e) ZeRO-3 at dp =
   2 (two bins by tokens) and dp = 2 x tp = 2, bwd_mode "split": loss and
   every grad bit-equal to the replicated layout on the same mesh, launches
   equal; "auto" within phase 4's bars; each rank's memory_allocated after
   shard_params + AdamW init in both layouts; a Trainer step without clip
   in each layout, whose gathered checkpoints the parent holds bit-equal
   (params and both moments); (f) Ulysses at sp = 2 x tp = 2 and sp = 4,
   (g) the ring at sp = 4 and sp = 2 x tp = 2, each against the one-device
   step on the same trie (its shards: loss rel SP_LOSS_RTOL, grads at phase
   4's bars), each drive's launches (Ulysses: K1, K10, no qk-prep kernel;
   the ring: K2, K11, K12 with offsets, K4-K7); (h) ``cli.train --dp 2 --sp
   2 --fsdp`` in the ranks' group for 2 steps, whose step 1 the parent
   holds against phase 11's ``--dp 1`` and whose checkpoint it resumes at
   ``--dp 1``. The kernels JSON marks K2, K11 and K12 with ``offsets``
   (the pairs' ms, the empty pairs, the worst error).

13. pipeline parallelism, GPipe and 1F1B, and the multi-host bring-up
   (``pp_phase``): the parent bins the bench rollouts with the Trainer's
   balancer into PP_M tries (and 2 x PP_M for dp = 2) and writes the
   one-device step summed over each set (loss and grads, the reference);
   then PP_WORLD ranks, fresh processes of this script (``--pp-rank``,
   ``pp_rank``) over gloo on the one card, laid out as 2 "hosts" x 2 with
   the environment of a two-node ``torchrun`` launch (``LOCAL_RANK``,
   ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` on
   localhost), the group started by ``initialize_multihost``; Qwen3-0.6B at
   28 layers: (a) GPipe and 1F1B at pp = 2 and pp = 4, pp = 2 x tp = 2 in
   both, dp = 2 x pp = 2 GPipe, each against the reference (its slices: loss
   rel SP_LOSS_RTOL, every grad at phase 4's bar, the worst leaf and the
   tied embedding printed); (b) each stage's launches equal to the
   schedule's count exactly (K1/K2, K10, K8/K9 on the last stage; no K3,
   K4-K7, K11, K12); (c) each process's peak memory at pp = 2 for M = PP_M
   and 2 PP_M microbatches of one size, both schedules: 1F1B's activation
   peak flat (within PP_FLAT), GPipe's growing; (d) ``cli.train --pp 2
   --pp-schedule 1f1b --microbatches 4``, whose step 1 the parent holds
   against phase 11's ``--dp 1`` and whose checkpoint it resumes at
   ``--pp 1``; (e) the HostInfo each rank gets, ``local_data_ranks`` of the
   dp = 2 x tp = 2 mesh, and phase 11's ``cli.train --dp 2 --tp 2`` argv
   with ``--multihost`` in ranks whose process group was destroyed first,
   so that the flag's ``initialize_multihost`` starts a fresh one from the
   launcher's environment (a second port): step 1 bit-equal to phase 11's
   (step 2 follows an update from the "cached" backward, whose dq sums in
   no fixed order: its difference is printed), the two hosts' losses
   bit-equal. (f) ``cli.warmup --model qwen3-0.6b``
   runs once in phase 1, after the build, as a process of its own.

Each phase prints its seconds. The last three lines are the per-kernel JSON, the card's name and power
limit from nvidia-smi, and the JSON status line.

    python3 chip_smoke.py --steps-only [--root DIR]

times only the tree training step in each backward mode, with its peak
memory, from the port under DIR (default: this checkout), and prints one
JSON line (``steps_ab``): run it on a checkout of another commit and on this
one, in turns, to compare the two in one call.

    python3 chip_smoke.py --kernels-only [--root DIR]

times K1, K2, K11, K12, K3 and K10 at offset 0 on the main path's shape, one
JSON line (``kernels_ab``), likewise: parent, change, change, parent in one
call keeps a kernel edit honest at the shape every drive runs.

    python3 chip_smoke.py --prepare-only [--root DIR]

times only ``Trainer.prepare_step`` on the bench trie (host ms, builds no
kernel) from the port under DIR, likewise (``prepare_ab``).

    python3 chip_smoke.py --adamw-only

builds every source (printing the AdamW source's ptxas lines) and runs
phase 10b alone (``adamw_only``): its lines, then the kernel rows as one
JSON line and the card line.

    python3 chip_smoke.py --mla-only

builds every source (printing the ptxas lines of the latent-attention
instantiations, ``tree_attn_fwd_mla_kernel`` and
``tree_attn_bwd_kmajor_mla_kernel``) and runs phase 10c alone
(``mla_only``): its lines, then its kernel rows and launches as one JSON
line and the card line.

    python3 chip_smoke.py --profiler-probe N [--after-warmup]

traces one K6 and one K7 call N times each between two marker kernels and
counts the traces that lost device events, in a fresh process, with
``--after-warmup`` after a ``cli.warmup`` process (``profiler_probe``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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


# The (head_dim, GQA group) pairs of MODEL_CONFIGS, each held at one
# config's head layout: Qwen2.5-1.5B's, one dh-64 pair (Llama-3.2-1B) and
# Qwen3-30B-A3B's (128, 8) on the bench trie, with kernels-JSON rows; the others on a
# trie of the bench batch's first 4 sequences (n ~ 2.5k, so the plain loops
# stay cheap).
SHAPE_CONFIGS = (("qwen3-0.6b", "small"), ("llama-3.2-3b", "small"), ("qwen3-4b", "small"),
                 ("qwen3-14b", "small"), ("qwen2.5-1.5b", "bench"), ("qwen2.5-7b", "small"),
                 ("llama-3.2-1b", "bench"), ("qwen2.5-0.5b", "small"), ("qwen3-30b-a3b", "bench"))
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


MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel: device_kernels' bracket
PROFILER_RETRACES: list = []  # (attempt, names) of each trace device_kernels took again
PROFILER_TRIES = 3  # traces device_kernels takes of one call before it fails


def traced_names(run) -> list[str]:
    """The device events of one traced run() in start order, bracketed by
    a launch of MARKER_KERNEL before it and one after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        run()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
    return [evt.name for evt in sorted(events, key=lambda evt: evt.time_range.start)]


def whole_trace(names: list[str]) -> bool:
    """Whether a traced_names() list holds both markers, first and last."""
    marks = [i for i, name in enumerate(names) if MARKER_KERNEL in name]
    return len(names) >= 2 and marks == [0, len(names) - 1]


def device_kernels(run) -> list[str]:
    """The names of the device kernels that one traced run() launched. Now
    and then the profiler hands back a trace that lost its device events
    (``--profiler-probe`` counts how often; PERF.md §7), so the run is
    traced between two marker kernels: a trace that lacks a marker is taken
    again, PROFILER_TRIES times in all at most, each retrace logged; a trace
    whose markers both came back is the answer, whatever it holds between
    them."""
    for attempt in range(1, PROFILER_TRIES + 1):
        names = traced_names(run)
        if whole_trace(names):
            return names[1:-1]
        PROFILER_RETRACES.append((attempt, names))
        log(f"device_kernels: trace {attempt} of {PROFILER_TRIES} lost a marker ({names}); traced again")
    fail(f"device_kernels: {PROFILER_TRIES} traces in a row lost a marker kernel: {names}")


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


# Phase 8: the rl_loop example at the sampler's GRPO decode widths (one
# prompt length for every prompt, as the JAX example takes it), and the
# grad-parity protocol on its committed data (16 sequences, 30831 tokens).
RL_ARGS = ["--n-prompts", "2", "--samples", "16", "--prompt-len", "1536", "--max-new", "384", "--iters", "3"]
PROTOCOL_DATA = os.path.join("data", "synthetic-tau2", "call0.npz")


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _fwd_counts(L: int) -> dict:
    """Launches of one forward of L layers: K1 or K2, K4, K5 each L times, K8 once."""
    return {**{key: 0 for key in step_counts("cached", L)}, "fwd": L, "lm_stats_fwd": 1,
            "qk_prep_fwd_q": L, "qk_prep_fwd_kv": L}


def rl_phase(params, mc, seqs, attachs, engine, split_engine, tree_batch, dense_batch) -> dict:
    """8. the RL loop and the grad-parity protocol through the port's entry
    points. (a) ``loss_and_grad_custom`` on the bench trie: a linear loss
    (the flatten weights written per sequence) against ``loss_and_grad``,
    the GRPO loss tree against dense, exact launch counts of one custom
    step, two ``"split"`` custom steps bit-equal, and the custom step
    against ``loss_and_grad`` in turns. (b) ``examples.rl_loop.main`` for
    three iterations, each call of the rollout, the behavior forward and the
    custom step counted on its own; on iteration 1's batch before the update
    a custom step with the mean completion log-prob per sequence, summed,
    against the same sum from ``TreeEngine.forward``'s log-probs. (c) the
    protocol through the CLIs in-process: ``cli.run`` tree and dense
    backward with ``--grad-out`` into a temporary directory, then
    ``cli.compare_grads``. Returns the phase's drives: {name: launches}."""
    import contextlib
    import io
    import tempfile

    from dynamictreeattn_tpu_torch.cli import compare_grads as cli_compare
    from dynamictreeattn_tpu_torch.cli import run as cli_run
    from dynamictreeattn_tpu_torch.engine import TreeEngine
    from dynamictreeattn_tpu_torch.examples import grpo, rl_loop
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

    L = mc.num_hidden_layers
    per_step = step_counts("cached", L)

    def linear_loss(lp, ent, extras, length):  # the bench trie's flatten weights: -1 and 0.1
        m_lp = (torch.arange(lp.shape[0], device=lp.device) < length - 1).float()
        m_en = (torch.arange(ent.shape[0], device=ent.device) < length).float()
        return -(lp * m_lp).sum() / torch.clamp(length - 1, min=1) + 0.1 * (ent * m_en).sum() / length

    # ---- (a) the custom step on the bench trie: counts from 0, drive, read
    _build.reset_launches()
    custom = engine.loss_and_grad_custom(params, tree_batch, linear_loss)
    custom_counts = _build.launches()
    got = counted(custom_counts, per_step)
    log(f"custom step (linear loss, tree, \"cached\"): launches {got}")
    if got != per_step or custom_counts["decode_attn"]:
        fail(f"custom step: launch counts {got}, expected {per_step} (28 layers under remat, K3 only)")
    check_step("custom step, linear loss vs loss_and_grad (tree)", (*custom, None),
               engine.loss_and_grad(params, tree_batch))
    del custom
    # GRPO extras shared by the two packings, by sequence id: behavior
    # log-probs of the tree forward plus noise (ratios away from 1) and
    # positive advantages, so that the loss is far from 0
    rng = np.random.default_rng(8)
    behavior = {b: (v + rng.normal(0.0, 0.1, size=v.shape)).astype(np.float32)
                for b, v in sorted(engine.forward(params, tree_batch).items())}
    adv = rng.uniform(0.5, 1.5, size=len(seqs)).astype(np.float32)
    prompt_lens = np.array([a["prompt_len"] for a in attachs])
    grpo_loss = grpo.make_grpo_loss(0.2, 0.01)
    tree_extras = grpo.grpo_extras(tree_batch, behavior, adv, prompt_lens, DEVICE)
    dense_extras = grpo.grpo_extras(dense_batch, behavior, adv, prompt_lens, DEVICE)
    check_step("custom step, GRPO loss, tree vs dense",
               (*engine.loss_and_grad_custom(params, tree_batch, grpo_loss, tree_extras), None),
               (*engine.loss_and_grad_custom(params, dense_batch, grpo_loss, dense_extras), None))
    _build.reset_launches()
    split_a = split_engine.loss_and_grad_custom(params, tree_batch, grpo_loss, tree_extras)
    got = counted(_build.launches(), per_step)
    if got != step_counts("split", L):
        fail(f"split custom step: launch counts {got}, expected {step_counts('split', L)}")
    split_b = split_engine.loss_and_grad_custom(params, tree_batch, grpo_loss, tree_extras)
    differ = [name for (name, a), (_, b) in zip(named_leaves(split_a[1]), named_leaves(split_b[1]))
              if not torch.equal(a, b)]
    log(f"two \"split\" custom steps (GRPO loss): loss {float(split_a[0]):.6f} / {float(split_b[0]):.6f}; "
        f"{len(differ)} of {len(list(named_leaves(split_a[1])))} grad leaves differ")
    if differ or not torch.equal(split_a[0], split_b[0]):
        fail(f"two split custom steps are not bit-equal: {differ[:5]}")
    del split_a, split_b
    (fast_ms, lin_ms, grpo_ms), turns = turns_ms(
        lambda: engine.loss_and_grad(params, tree_batch),
        lambda: engine.loss_and_grad_custom(params, tree_batch, linear_loss),
        lambda: engine.loss_and_grad_custom(params, tree_batch, grpo_loss, tree_extras))
    log(f"tree step in turns (ms, median of 4): loss_and_grad {fast_ms:.2f}, custom linear {lin_ms:.2f} "
        f"(x{lin_ms / fast_ms:.3f}), custom GRPO {grpo_ms:.2f} (x{grpo_ms / fast_ms:.3f}); all: "
        + "; ".join(", ".join(f"{t:.2f}" for t in ts) for ts in turns))

    # ---- (b) the RL loop: each rollout, behavior forward and custom step
    # counted on its own; iteration 1's batch and weights kept for the check
    calls, first = {"rollout": [], "forward": [], "custom": []}, {}
    real = {"rollout": rl_loop.generate_grouped, "forward": TreeEngine.forward,
            "custom": TreeEngine.loss_and_grad_custom}

    def counting(kind):
        def run(*args, **kwargs):
            if kind == "custom" and not first.get("params"):
                eng_, params_, batch_, _, extras_ = args
                first.update(engine=eng_, params=_clone_tree(params_), batch=batch_, extras=extras_)
            before = _build.launches()
            out = real[kind](*args, **kwargs)
            after = _build.launches()
            calls[kind].append({key: after[key] - before[key] for key in after})
            if kind == "forward" and "old_lp" not in first:
                first["old_lp"] = out
            return out
        return run

    rl_loop.generate_grouped = counting("rollout")
    TreeEngine.forward, TreeEngine.loss_and_grad_custom = counting("forward"), counting("custom")
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        hist = rl_loop.main(["--model", MODEL, "--device", DEVICE] + RL_ARGS)
        loop_s = time.perf_counter() - t0
        loop_launches = _build.launches()
    finally:
        rl_loop.generate_grouped = real["rollout"]
        TreeEngine.forward, TreeEngine.loss_and_grad_custom = real["forward"], real["custom"]
    steps = int(RL_ARGS[RL_ARGS.index("--max-new") + 1]) - 1
    want = {"rollout": {**{key: 0 for key in loop_launches}, "decode_attn": L * steps}}
    for it, rec in enumerate(hist):
        log(f"rl_loop iteration {rec['iter']}: loss {rec['loss']:.6f}, mean reward {rec['mean_reward']:.4f}, "
            f"{rec['n_tree_tokens']} tree tokens; t_rollout {rec['t_rollout']:.4f} s, t_behavior_fwd "
            f"{rec['t_behavior_fwd']:.4f} s, t_train {rec['t_train']:.4f} s, t_iter {rec['t_iter']:.4f} s; "
            f"peak {rec.get('peak_mem_gb', float('nan')):.3f} GiB; launches: rollout "
            f"{ {k: v for k, v in calls['rollout'][it].items() if v} }, behavior forward "
            f"{ {k: v for k, v in calls['forward'][it].items() if v} }, custom step "
            f"{ {k: v for k, v in calls['custom'][it].items() if v} }")
        if calls["rollout"][it] != want["rollout"]:
            fail(f"iteration {rec['iter']}: rollout launches {calls['rollout'][it]}, expected {L} x {steps} K13")
        for kind, like in (("forward", _fwd_counts(L)), ("custom", per_step)):
            if counted(calls[kind][it], like) != like or calls[kind][it]["decode_attn"]:
                fail(f"iteration {rec['iter']}: {kind} launches {calls[kind][it]}, expected {like}")
    if len(hist) != 3 or not all(math.isfinite(rec["loss"]) for rec in hist):
        fail(f"rl_loop: {len(hist)} iterations, losses {[rec['loss'] for rec in hist]}")
    log(f"rl_loop: {loop_s:.1f} s for {len(hist)} iterations (model init included); launches {loop_launches}")

    def completion_mean(lp, ent, extras, length):
        t = torch.arange(lp.shape[0], device=lp.device)
        m = ((t < length - 1) & (t >= extras["prompt_len"] - 1)).float()
        return (lp * m).sum() / torch.clamp(m.sum(), min=1.0)

    plen = int(RL_ARGS[RL_ARGS.index("--prompt-len") + 1])
    lin, _ = first["engine"].loss_and_grad_custom(first["params"], first["batch"], completion_mean, first["extras"])
    ref = sum(float(v[plen - 1:].astype(np.float64).mean()) for v in first["old_lp"].values())
    rel = abs(float(lin) - ref) / abs(ref)
    log(f"iteration 1's batch: custom step's summed mean completion log-prob {float(lin):.6f} vs "
        f"TreeEngine.forward's {ref:.6f} (rel {rel:.3e}, tol {TREE_DENSE_SUM_RTOL})")
    if rel > TREE_DENSE_SUM_RTOL:
        fail("the custom step's log-probs disagree with TreeEngine.forward's on the RL batch")
    del first

    # ---- (c) the grad-parity protocol through the CLIs
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), PROTOCOL_DATA)
    records, save_s = {}, {}
    real_save = cli_run.save_grads_npz

    def timed_save(path, grads):
        t = time.perf_counter()
        real_save(path, grads)
        save_s[os.path.basename(path)] = time.perf_counter() - t

    cli_run.save_grads_npz = timed_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _build.reset_launches()
            for run in ("tree_backward", "dense_backward"):
                torch.cuda.reset_peak_memory_stats()
                out, t0 = io.StringIO(), time.perf_counter()
                with contextlib.redirect_stdout(out):
                    cli_run.main(["--model", MODEL, "--device", DEVICE, "--data", data, "--run", run,
                                  "--iters", "1", "--grad-out", os.path.join(tmp, f"{run}.npz")])
                records[run] = json.loads(out.getvalue().strip().splitlines()[-1])
                log(f"cli.run --run {run}: {time.perf_counter() - t0:.1f} s in all; record {records[run]}")
            protocol_launches = _build.launches()
            out, t0 = io.StringIO(), time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli_compare.main(["--baseline-grad", os.path.join(tmp, "dense_backward.npz"),
                                  "--exp-grad", os.path.join(tmp, "tree_backward.npz")])
            compare_s = time.perf_counter() - t0
            sizes = {name: os.path.getsize(os.path.join(tmp, name)) / 2**30 for name in save_s}
    finally:
        cli_run.save_grads_npz = real_save
    table = out.getvalue().strip().splitlines()
    tail = table[-1]
    max_rel = float(tail.split("max")[1].split()[0])
    loss_rel = abs(records["tree_backward"]["loss"] - records["dense_backward"]["loss"]) / abs(
        records["dense_backward"]["loss"])
    log(f"grad-parity protocol on {PROTOCOL_DATA}: grad files "
        + ", ".join(f"{name} {sizes[name]:.3f} GiB written in {save_s[name]:.2f} s" for name in save_s)
        + f"; cli.compare_grads {compare_s:.1f} s; worst 3 rows: {' | '.join(' '.join(r.split()) for r in table[1:4])}")
    log(f"grad-parity table's last line: {tail}; loss tree {records['tree_backward']['loss']:.6f} vs dense "
        f"{records['dense_backward']['loss']:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_RTOL}); max rel tol "
        f"{STEP_GRAD_REL}")
    if loss_rel > STEP_LOSS_RTOL or not max_rel <= STEP_GRAD_REL:
        fail("the grad-parity protocol is outside its bars")
    return {"custom step": custom_counts, "rl loop": loop_launches, "grad-parity protocol": protocol_launches}


# the trainer phase (9): remat settings of the tree training step, in the
# order the issue's table lists them, each an EngineConfig's remat fields
TRAINER_SETTINGS = (("off", dict(remat=False)), ("None", dict()),
                    ('"attn"', dict(remat_policy="attn")), ('"dots"', dict(remat_policy="dots")),
                    ('"attn_dots"', dict(remat_policy="attn_dots")),
                    ("None, 4 segments", dict(remat_segments=4)),
                    ('"attn", 4 segments', dict(remat_policy="attn", remat_segments=4)))
# Adam's first steps move each weight by about the learning rate: at 1e-3
# (1e-4 under the first warmup step) they move bf16 weights of ~0.03, whose
# spacing is ~1.2e-4, where 1e-5 would round away
TRAINER_LR = 1e-3
# the checkpoint round trip's data: cli.train re-samples it each step from
# --seed plus the step index
CKPT_DATA = "synthetic:n_prompts=1,samples=8,prompt_lo=512,prompt_hi=1024,completion_lo=64,completion_hi=256"
# the memory probe: Qwen3-4B (36 layers), full recompute and 6 nested segments
PROBE_MODEL, PROBE_SEGMENTS = "qwen3-4b", 6


def remat_step_counts(L: int, remat: bool = True, remat_policy=None, remat_segments: int = 0) -> dict:
    """Launches of one "cached" training step of L layers under a remat
    setting: without remat one forward (K1/K2, K4, K5 L times); under remat
    the recompute adds a second, but "attn"/"attn_dots" hand the first
    forward's (o, lse) to it, so K1/K2 run L times and K4/K5 2L. G nested
    segments run each layer's forward in the outer forward, the outer
    recompute and the inner recompute, except in the outer recompute of
    each segment's last layer, where PyTorch's early-stopping checkpoint
    stops: 3L - G; under "attn"/"attn_dots" the inner recompute takes the
    (o, lse) the outer recompute kept, so K1/K2 run there only for the G
    last layers: L + (L - G) + G = 2L."""
    fwd = qk = 2 * L
    if not remat:
        fwd = qk = L
    elif remat_segments:
        qk = 3 * L - remat_segments
        fwd = 2 * L if remat_policy in ("attn", "attn_dots") else qk
    elif remat_policy in ("attn", "attn_dots"):
        fwd = L
    return {**step_counts("cached", L), "fwd": fwd, "qk_prep_fwd_q": qk, "qk_prep_fwd_kv": qk}


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))


def trainer_phase(params, mc, dev, batch, seqs, attachs) -> dict:
    """9. the single-card trainer path. (a) one tree training step per remat
    setting (``TRAINER_SETTINGS``), each from the same params on the bench
    batch: exact launches from 0 (``remat_step_counts``), the first step's
    loss bit-equal across settings, grads against policy None's by the
    per-parameter max rel within 4x that of two None steps against each
    other (the "cached" backward adds dq in no fixed order), every setting
    bit-equal to None under ``bwd_mode="split"``; each setting's step ms in turns,
    the step's peak memory above the resident tensors, and the K1 class of
    its profile. (b) ``Trainer`` (bf16, clip 1.0, warmup 2, lr TRAINER_LR,
    policy "attn"): 3 ``train_step`` on the bench batch, step 1's loss
    bit-equal to ``TreeEngine.loss_and_grad``'s, every loss finite, step 3's
    below step 1's, exactly one host synchronisation in each step after its
    batch is stacked (``torch.cuda.set_sync_debug_mode("warn")``), 3 points
    in the time model, the split of each step and the host ms of its
    ``prepare_step``. (c) ``cli.train``
    (split backward): 2 steps with --ckpt-dir/--ckpt-every 2, then --resume
    for 1, bit-equal to 3 steps in one run; a Trainer's restore of the
    saved step bit-equal to the file and to the trainer that saved it; save
    and restore seconds. (d) Qwen3-4B: one trainer step with policy None and
    with PROBE_SEGMENTS segments, peak memory and step ms. Returns the
    phase's drives: {name: launches}."""
    import contextlib
    import gc
    import io
    import tempfile
    import warnings

    from dynamictreeattn_tpu_torch.cli import train as cli_train
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer
    from dynamictreeattn_tpu_torch.utils import compare_grads

    L = mc.num_hidden_layers
    drives = {}
    # ---- (a) one step per remat setting
    engines = {label: TreeEngine(mc, EngineConfig(**kw), device=dev) for label, kw in TRAINER_SETTINGS}
    ref = engines["None"].loss_and_grad(params, batch)
    twin = engines["None"].loss_and_grad(params, batch)
    bar = compare_grads(ref[1], twin[1])[0][1]
    del twin
    log(f"trainer phase: two policy-None steps, grad max rel {bar:.4e}: the bar is 4x that")
    rows = {}
    for label, kw in TRAINER_SETTINGS:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        loss, grads, _ = engines[label].loss_and_grad(params, batch)
        counts = _build.launches()
        peak = torch.cuda.max_memory_allocated()
        want = remat_step_counts(L, **kw)
        got = counted(counts, want)
        drives[f"trainer step, remat {label}"] = counts
        rel = compare_grads(ref[1], grads)[0][1]
        rows[label] = {"loss": float(loss), "peak_gib": peak / 2**30, "step_peak_gib": (peak - resident) / 2**30,
                       "rel": rel, "K1": got["fwd"]}
        log(f"remat {label}: loss {float(loss):.9g}; launches {got}; grads vs None max rel {rel:.4e}; peak "
            f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB above the {resident / 2**30:.3f} "
            f"GiB resident)")
        if got != want or counts["decode_attn"]:
            fail(f"remat {label}: launch counts {got}, expected {want}")
        if not torch.equal(loss, ref[0]):
            fail(f"remat {label}: first-step loss {float(loss)!r} is not bit-equal to policy None's "
                 f"{float(ref[0])!r}")
        if rel > 4 * bar:
            fail(f"remat {label}: grads vs None max rel {rel:.4e} past 4x two None steps' {bar:.4e}")
        del loss, grads
    del ref
    split = {label: TreeEngine(mc, EngineConfig(bwd_mode="split", **kw), device=dev) for label, kw in TRAINER_SETTINGS}
    split_ref = split["None"].loss_and_grad(params, batch)
    for label in split:
        if label == "None":
            continue
        out = split[label].loss_and_grad(params, batch)
        same = torch.equal(out[0], split_ref[0]) and _tree_equal(out[1], split_ref[1])
        log(f"bwd_mode=\"split\": remat {label} vs None bit-equal: {same}")
        if not same:
            fail(f"bwd_mode=\"split\": the remat {label} step is not bit-equal to policy None's")
        del out
    del split_ref, split
    runs = [lambda e=engines[label]: e.loss_and_grad(params, batch) for label, _ in TRAINER_SETTINGS]
    ms, turns = turns_ms(*runs, warm=False)
    for (label, _), t, ts in zip(TRAINER_SETTINGS, ms, turns):
        layers_ = profile_run(runs[[lab for lab, _ in TRAINER_SETTINGS].index(label)], f"training step, remat {label}")
        rows[label].update(ms=t, k1_class_ms=layers_.get("tree attention fwd (K1/K2)"))
        k1 = layers_.get("tree attention fwd (K1/K2)")
        log(f"remat {label}: step {t:.2f} ms (median of 4 in turns: {', '.join(f'{x:.2f}' for x in ts)}); "
            f"K1/K2 class in the profile {'not measured' if k1 is None else f'{k1:.2f} ms'} for "
            f"{rows[label]['K1']} launches")
    log("remat settings (step ms, step peak above resident GiB, K1 launches): " + json.dumps(
        {label: [round(r["ms"], 3), round(r["step_peak_gib"], 3), r["K1"]] for label, r in rows.items()}))
    del engines, runs

    # ---- (b) the Trainer at full width
    ec = EngineConfig(remat_policy="attn")
    tr = Trainer(mc, ec, TrainConfig(param_dtype="bf16", grad_clip=1.0, warmup_steps=2,
                                     learning_rate=TRAINER_LR), device=dev)
    tr.set_params(params)
    want_loss = TreeEngine(mc, ec, device=dev).loss_and_grad(params, batch)[0]
    n_tokens = int(sum(len(s) for s in seqs))
    recs = []
    prep_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        stacked, tries = tr.prepare_step(seqs, attachs)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        tr.time_parts = True
        _build.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec = tr.run_step(stacked, tries, len(seqs), n_tokens)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        drives[f"trainer train_step {i + 1}"] = counts = _build.launches()
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        recs.append(rec)
        log(f"Trainer step {i + 1}: {json.dumps(rec)}; host synchronisations in the step after stacking: "
            f"{len(syncs)} ({'; '.join(f'{os.path.basename(w.filename)}:{w.lineno}' for w in syncs)}); "
            f"parts (ms) {json.dumps(tr.last_parts_ms)}; launches "
            f"{counted(counts, remat_step_counts(L, remat_policy='attn'))}")
        if len(syncs) != 1:
            fail(f"Trainer step {i + 1}: {len(syncs)} host synchronisations, expected one")
    losses = [r["loss"] for r in recs]
    if losses[0] != float(want_loss):
        fail(f"Trainer step 1's loss {losses[0]!r} is not bit-equal to loss_and_grad's {float(want_loss)!r}")
    if not all(math.isfinite(x) for x in losses) or not losses[2] < losses[0]:
        fail(f"Trainer losses {losses}: not all finite, or step 3's not below step 1's (lr {TRAINER_LR})")
    if len(tr.time_model._y) != 3:
        fail(f"the time model has {len(tr.time_model._y)} points after 3 steps")
    log(f"Trainer: losses {losses} (lr {TRAINER_LR}, warmup 2, clip 1.0), step 1 bit-equal to loss_and_grad; "
        f"time model points {len(tr.time_model._y)}; prepare_step host ms {', '.join(f'{x:.2f}' for x in prep_ms)}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the checkpoint round trip through cli.train
    with tempfile.TemporaryDirectory() as tmp:
        a_dir, b_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        argv = ["--model", MODEL, "--device", DEVICE, "--data", CKPT_DATA, "--bwd-mode", "split",
                "--lr", str(TRAINER_LR), "--warmup-steps", "2"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            first = cli_train.main(argv + ["--steps", "2", "--ckpt-dir", a_dir, "--ckpt-every", "2"])
            resumed = cli_train.main(argv + ["--steps", "1", "--ckpt-dir", a_dir, "--resume"])
            whole = cli_train.main(argv + ["--steps", "3", "--ckpt-dir", b_dir])
        lines = out.getvalue().strip().splitlines()
        log("cli.train: " + " | ".join(lines))
        same = (resumed.step_idx == whole.step_idx == 3 and _tree_equal(resumed.params, whole.params)
                and _tree_equal(resumed.opt_state, whole.opt_state))
        log(f"cli.train --bwd-mode split: 2 steps + --resume 1 step bit-equal to 3 steps in one run: {same}")
        if not same:
            fail("the resumed cli.train run is not bit-equal to the uninterrupted one")
        del resumed, whole
        saved = torch.load(os.path.join(a_dir, "step_2.pt"), map_location=dev, weights_only=True)
        t0 = time.perf_counter()
        first.save()
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        back = Trainer(mc, EngineConfig(bwd_mode="split"), first.tc, device=dev)
        t0 = time.perf_counter()
        back.restore(2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        size_gib = os.path.getsize(os.path.join(a_dir, "step_2.pt")) / 2**30
        ok = (_tree_equal(back.params, saved["params"]) and _tree_equal(back.opt_state, saved["opt_state"])
              and _tree_equal(first.params, saved["params"]) and _tree_equal(first.opt_state, saved["opt_state"]))
        log(f"checkpoint of step 2 ({size_gib:.3f} GiB: params, AdamW moments, counters): save {save_s:.2f} s, "
            f"restore {restore_s:.2f} s; restored == saved == the saving trainer's, bitwise: {ok}")
        if not ok:
            fail("the restored params / optimizer state are not bit-equal to the saved ones")
        del first, back, saved
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the memory probe: Qwen3-4B, full recompute and nested segments
    pmc = MODEL_CONFIGS[PROBE_MODEL]
    for label, kw in (("None", {}), (f"None, {PROBE_SEGMENTS} segments", dict(remat_segments=PROBE_SEGMENTS))):
        tr = Trainer(pmc, EngineConfig(**kw), TrainConfig(param_dtype="bf16", learning_rate=TRAINER_LR),
                     device=dev)
        tr.init(seed=0)
        stacked, tries = tr.prepare_step(seqs, attachs)
        tr.run_step(stacked, tries, len(seqs), n_tokens)  # warm
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = tr.run_step(stacked, tries, len(seqs), n_tokens)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{PROBE_MODEL} trainer step, remat {label}: {step_ms:.1f} ms, peak {peak:.3f} GiB "
            f"({peak - resident / 2**30:.3f} GiB above the {resident / 2**30:.3f} GiB of params and AdamW "
            f"state), loss {rec['loss']:.6f}")
        if not math.isfinite(rec["loss"]):
            fail(f"{PROBE_MODEL} probe ({label}): non-finite loss")
        del tr, stacked
        gc.collect()
        torch.cuda.empty_cache()
    return drives


# Phase 10: the Qwen3-MoE family at Qwen3-30B-A3B's full width (48 layers,
# d = 2048, 32 q / 4 kv heads, group 8, 128 experts, top-8, expert width
# 768, untied head; 30.53 B parameters, 61.1 GB in bf16). The scoring
# forward and the rollout run all 48 layers; the training steps, the
# Trainer and the HF round trip run the first layers of the same
# architecture, as many as their weights, grads, optimizer state and
# activations leave room for on one card.
MOE_MODEL = "qwen3-30b-a3b"
MOE_STEP_LAYERS, MOE_PARITY_LAYERS, MOE_TRAINER_LAYERS, MOE_HF_LAYERS = 12, 8, 4, 2
# the dense replay at the no-drop capacity runs in chunks of whole
# sequences of at most this many tokens each (capacity = n makes the expert
# buffer [E, n, d]: 3.5 GB at n = 6656), the training chunks half as large
MOE_DENSE_CHUNK = 6656
# rollout: the sampler phase's prompts and new tokens; the decode step's
# host and busy ms over a window of this many replays
MOE_NEW, MOE_DECODE_WINDOW = 384, 8
# the dense packing's routing (the model's own ``moe_route``) against the
# tree's recorded top-k choices at the same (token, layer), (share, gap)
# limits: the share of real (token, layer) choices whose top-k set differs,
# and the most that a differing choice's own k-th expert outranks the
# weakest recorded one, in nats of its router log-probabilities (a
# near-tie flips; a misrouted row is far from one). With the routing
# history shared (the dense side's layers route by the tree's choices)
# only the packings' rounding differs; on its own, each flip moves the
# later layers' inputs as well. Measured on an H100 80GB HBM3 (random
# weights from seed 0): shared, (a) 9.24e-2 of the choices, gap at most
# 0.078 nats, (b) 5.52e-2, 0.035; on its own, (a) 0.351, 0.869, (b) 0.191,
# 1.162
MOE_FLIPS_SHARED, MOE_FLIPS_OWN = (0.12, 0.12), (0.5, 2.0)
KERNEL_IDS = {"tree_attn_fwd_bound": "K1", "tree_attn_fwd_online": "K2", "tree_attn_bwd_cached": "K3",
              "tree_attn_bwd_fused": "K10", "tree_attn_bwd_dq": "K11", "tree_attn_bwd_dkv": "K12",
              "qk_prep_fwd_q": "K4", "qk_prep_fwd_kv": "K5", "qk_prep_bwd_q": "K6", "qk_prep_bwd_kv": "K7",
              "lm_stats_fwd": "K8", "lm_stats_bwd": "K9", "decode_attn": "K13", "adamw_update": "A1",
              "adamw_sum_squares": "A2"}


def by_id(counts: dict) -> str:
    return json.dumps({KERNEL_IDS[k]: v for k, v in counts.items() if v})


@contextlib.contextmanager
def moe_routing(mq, mode: str, calls: list, pos_map=None, stats=None):
    """``models/qwen3.py``'s ``moe_route`` patched for a tree-vs-dense
    comparison of a top-k MoE. Top-k choices flip where two experts'
    probabilities lie within bf16 noise of each other, and the two packings
    round differently: a flipped token's log-prob moves by more than any
    rounding does. "record": route as the model does and append each call's
    expert ids ([n, k], in call order: the forward's layers, then a
    recompute's) to `calls`. "share": call j routes row r to the experts of
    recorded row pos_map[r] of calls[j] (padding rows to none), its weights
    its own probabilities there (renormalised as the model does); the
    load-balance loss is 0 (run with router_aux_coef 0). "own": route as
    the model does. With `stats`, "share" and "own" run the model's
    routing and append for call j, against recorded row pos_map[r] of
    calls[j]: the real rows ([n] bool, from valid), those whose top-k set
    differs from the recorded one (flipped), each row's gap (the router
    log-probability of its own k-th choice less that of the weakest
    recorded choice; >= 0 where it flipped) and the count of rows whose
    routing disagrees with valid (a real row sent to no expert, a padding
    row to one)."""
    real, state = mq.moe_route, {"j": 0}

    def compared(h, router, config, valid, handoff, groups, recorded):
        w, idx, lb = real(h, router, config, valid, handoff, groups=groups)
        E = config.num_experts
        real_rows = valid > 0 if valid is not None else torch.ones_like(idx[:, 0], dtype=torch.bool)
        flipped = (idx.sort(-1).values != recorded.sort(-1).values).any(-1) & real_rows
        logp = torch.log_softmax(h.detach().float() @ router.detach().float(), dim=-1)
        gap = logp.gather(1, idx.clamp(max=E - 1)).amin(-1) - logp.gather(1, recorded.clamp(max=E - 1)).amin(-1)
        bad = torch.where(real_rows, (idx >= E).any(-1), (idx < E).any(-1)).sum()
        stats.append((real_rows, flipped, gap, bad))
        return w, idx, lb

    def record(h, router, config, valid=None, handoff=None, groups=()):
        w, idx, lb = real(h, router, config, valid, handoff, groups=groups)
        calls.append(idx)
        return w, idx, lb

    def share(h, router, config, valid=None, handoff=None, groups=()):
        idx = calls[state["j"]][pos_map]
        state["j"] += 1
        if stats is not None:
            compared(h, router, config, valid, handoff, groups, idx)
        probs = torch.softmax(h.float() @ router.float(), dim=-1)
        w = probs.gather(1, idx)
        if config.norm_topk_prob:
            w = w / w.sum(-1, keepdim=True)
        if valid is not None:
            idx = torch.where(valid[:, None] > 0, idx, config.num_experts)
        return w, idx, torch.zeros((), dtype=torch.float32, device=h.device)

    def own(h, router, config, valid=None, handoff=None, groups=()):
        recorded = calls[state["j"]][pos_map]
        state["j"] += 1
        return compared(h, router, config, valid, handoff, groups, recorded)

    mq.moe_route = {"record": record, "share": share, "own": own}[mode]
    try:
        yield
    finally:
        mq.moe_route = real


@contextlib.contextmanager
def moe_drops(mq):
    """``models/qwen3.py``'s ``moe_apply`` wrapped: each call appends to the
    yielded list an int64 device tensor [4] worked out from its expert ids
    and capacity, with no host read: the (row, choice) pairs routed to an
    expert, those dropped past capacity (the sum over experts of
    max(0, count - capacity)), the most pairs one expert received, and the
    capacity. A layer under remat records in its recompute too."""
    real, rec = mq.moe_apply, []

    def wrapped(h, e_gate, e_up, e_down, idx, w, capacity):
        E, flat = e_gate.shape[0], idx.reshape(-1).long()
        counts = torch.zeros(E + 1, dtype=torch.int64, device=idx.device).scatter_add_(
            0, flat.clamp(max=E), torch.ones_like(flat))[:E]  # integer adds: exact in any order
        rec.append(torch.stack([counts.sum(), (counts - capacity).clamp(min=0).sum(), counts.max(),
                                torch.full_like(counts[0], capacity)]))
        return real(h, e_gate, e_up, e_down, idx, w, capacity)

    mq.moe_apply = wrapped
    try:
        yield rec
    finally:
        mq.moe_apply = real


def tree_rows(tree_packed, packed, ids) -> np.ndarray:
    """For each row of `packed` (a dense chunk whose local sequence j is
    sequence ids[j]), the tree row of the same token (0 for padding)."""
    t_paths, d_paths = tree_packed.seq_paths_matrix(), packed.seq_paths_matrix()
    t_row = {int(b): r for r, b in enumerate(tree_packed.seq_batch_ids)}
    out = np.zeros(packed.n_padded, np.int64)
    for r, (b, n_) in enumerate(zip(packed.seq_batch_ids, packed.seq_lens)):
        out[d_paths[r, :n_]] = t_paths[t_row[ids[int(b)]], :n_]
    return out


def write_safetensors(path: str, tensors: dict) -> int:
    """{name: tensor} (BF16, F16 or F32) as one ``.safetensors`` file: an
    8-byte little-endian header length, the JSON header (dtype, shape, byte
    offsets), then each tensor's raw bytes in order, copied to the host one
    at a time. Returns the bytes written."""
    import struct

    codes = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
    header, off = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + nbytes]}
        off += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + off


def moe_phase(seqs, attachs, dev, flush) -> dict:
    """10. the Qwen3-MoE family at Qwen3-30B-A3B's full width (MOE_MODEL,
    random bf16 weights from seed 0). Each part prints its ms, device busy
    (a profile), peak memory, kernel launches by id from 0, and, where it
    routes, the (row, choice) pairs dropped past capacity per layer and the
    load-balance loss; everything is freed before the next part.
    (a) the scoring forward at 48 layers on the bench trie: at capacity
    factor E/k (capacity = n: no pair can drop; the dense replay in chunks
    of whole sequences), tree vs dense per-token log-probs at the §2 bars
    with the dense side routed by the tree's choices, its own routing held
    against them (MOE_FLIPS_SHARED), the sum bar and MOE_FLIPS_OWN routing
    on its own, and zero drops; then the default factor, tree and dense,
    timed in turns. (c) the GRPO rollout at 48 layers (the sampler phase's prompts,
    2 x 16 branches, MOE_NEW tokens) through the replayed decode step:
    one capture, 48 K13 launches a step, replayed greedy tokens equal to
    the eager loop's, the decode step's host ms against its busy ms and
    the floor of reading every expert once (a window of replays of one
    captured step). (b) the training step:
    at MOE_PARITY_LAYERS layers tree vs dense (chunks summed) at capacity
    factor E/k without the load-balance term (loss rel and per-parameter
    grad rel at the §2 bars, zero drops; routing held against the tree's
    choices as in (a), the loss at its bar routing on its own), two
    ``bwd_mode="split"`` steps
    bit-equal, one MoE layer forward + backward under
    ``torch.cuda.set_sync_debug_mode("error")``; at MOE_STEP_LAYERS layers
    the default step ("auto" = K3, fused qk-prep, the aux loss on): exact
    launches, finite loss, router and expert grads non-zero, and the tree
    and dense steps in turns. (d) ``Trainer`` for 3 steps at
    MOE_TRAINER_LAYERS layers: one host read a step, finite losses. (e) the
    HF bridge: MOE_HF_LAYERS layers written as HF safetensors shards (this
    script's writer), loaded through ``load_hf_checkpoint`` bit-equal, and
    ``cli.run`` with ``--ckpt`` equal to the run on the same weights in
    memory. Returns {drive: launch counts} (names "MOE_MODEL ...")."""
    import gc
    import io
    import tempfile
    import warnings

    import dynamictreeattn_tpu_torch.models.generate  # noqa: F401  (the module, not the function)
    import dynamictreeattn_tpu_torch.models.qwen3 as mq
    from dynamictreeattn_tpu_torch.cli import run as cli_run
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine, pack_sequences_dense
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, generate_grouped, init_params
    from dynamictreeattn_tpu_torch.models.hf_compat import load_hf_checkpoint, to_hf_state_dict
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer
    from dynamictreeattn_tpu_torch.tries import TokenTrie
    from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

    gm = sys.modules["dynamictreeattn_tpu_torch.models.generate"]
    bf16 = torch.bfloat16
    mc = MODEL_CONFIGS[MOE_MODEL]
    E, k, L = mc.num_experts, mc.num_experts_per_tok, mc.num_hidden_layers
    free_factor = E / k  # capacity = ceil(E/k * n * k / E) = n: an expert can take every row
    drives = {}

    def free_all():
        gc.collect()
        torch.cuda.empty_cache()

    def gib(x: float) -> float:
        return x / 2**30

    def layers_of(n_layers: int):
        return dataclasses.replace(mc, num_hidden_layers=n_layers)

    def n_params(p) -> int:
        return sum(t.numel() for _, t in named_leaves(p))

    def drops(rec, label: str, layers: int | None = None, must_be_zero: bool = False) -> str:
        """Per-layer dropped pairs (min / max / total) of a ``moe_drops``
        list, the first `layers` entries (the forward's; a recompute repeats
        them)."""
        rows = torch.stack(rec[:layers] if layers else rec).cpu().tolist()
        dropped = [r[1] for r in rows]
        text = (f"{label}: {len(rows)} MoE blocks, capacity {rows[0][3]}, routed pairs {rows[0][0]}, dropped "
                f"per block min {min(dropped)} / max {max(dropped)} / total {sum(dropped)}, the most pairs one "
                f"expert received {max(r[2] for r in rows)} (mean {rows[0][0] / E:.1f})")
        if must_be_zero and sum(dropped):
            fail(f"{text}: pairs dropped at capacity factor {free_factor:g}")
        return text

    def flips(label: str, stats, limits) -> str:
        """The dense packing's routing against the tree's choices
        (``moe_routing`` stats): fails on a row routed against valid, or past
        `limits` = (flip share, gap in nats)."""
        n_real = int(sum(int(r.sum()) for r, _, _, _ in stats))
        n_bad = int(sum(int(b) for _, _, _, b in stats))
        gaps = torch.cat([g[f] for _, f, g, _ in stats]).cpu().double().numpy()
        share = gaps.size / max(n_real, 1)
        text = (f"{label}: (token, layer) choices whose top-{k} set differs from the tree's {gaps.size} of {n_real} "
                f"({share:.4e}, limit {limits[0]}); their gap (own k-th choice over the weakest tree choice, "
                f"router log-prob) "
                + (f"median {np.median(gaps):.4e}, p99 {np.quantile(gaps, 0.99):.4e}, p99.9 "
                   f"{np.quantile(gaps, 0.999):.4e}, max {gaps.max():.4e} nats" if gaps.size else "none")
                + f" (limit {limits[1]}); rows routed against valid {n_bad}")
        if n_bad or share > limits[0] or (gaps.size and gaps.max() > limits[1]):
            fail(text)
        return text

    def measured(label: str, run, want=None, profile: bool = True):
        """run() from launch counts of 0 and a reset peak: (result, host ms,
        counts); logs ms, the peak, launches by id and (`profile`) the busy
        ms of a traced run. `want` = exact expected counts."""
        free_all()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _build.launches()
        peak = torch.cuda.max_memory_allocated()
        busy = ""
        if profile:
            layers_ms = profile_run(run, f"{MOE_MODEL} {label}")
            busy = f", device busy {sum(layers_ms.values()):.2f} ms (profile)" if layers_ms else ", busy not measured"
        log(f"{MOE_MODEL} {label}: {ms:.2f} ms (host clock, first run){busy}; max_memory_allocated "
            f"{gib(peak):.3f} GiB ({gib(peak - base):.3f} above the {gib(base):.3f} GiB resident); launches "
            f"{by_id(counts)}")
        if want is not None and as_fwd(counts) != {key: want.get(key, 0) for key in counts}:
            fail(f"{MOE_MODEL} {label}: launches {by_id(counts)}, expected {by_id(want)} (K1 + K2 counted "
                 "together: the bound dispatch picks either on the card)")
        return out, ms, counts

    def fwd_want(n_layers):
        return {"tree_attn_fwd_bound": n_layers, "qk_prep_fwd_q": n_layers, "qk_prep_fwd_kv": n_layers,
                "lm_stats_fwd": 1}

    def as_fwd(counts):  # the bound dispatch picks K1 or K2 on the card: count them together
        return {**counts, "tree_attn_fwd_bound": counts["tree_attn_fwd_bound"] + counts["tree_attn_fwd_online"],
                "tree_attn_fwd_online": 0}

    def dense_chunks(max_tokens: int) -> list[list[int]]:
        chunks, cur, size = [], [], 0
        for i, s in enumerate(seqs):
            if cur and size + len(s) > max_tokens:
                chunks.append(cur)
                cur, size = [], 0
            cur.append(i)
            size += len(s)
        return chunks + [cur]

    def dense_batch_of(engine, chunk):
        return engine.prepare(pack_sequences_dense([seqs[i] for i in chunk], [attachs[i] for i in chunk],
                                                   pad_multiple=engine.cfg.pad_multiple))

    log(f"{MOE_MODEL}: memory allocated at the phase's start {gib(torch.cuda.memory_allocated()):.3f} GiB "
        f"(the earlier phases' tensors)")
    t0 = time.perf_counter()
    params = init_params(mc, torch.Generator(device=dev).manual_seed(0), bf16)
    torch.cuda.synchronize()
    n_all = n_params(params)
    expert_bytes = sum(params["layers"][name].numel() * 2 for name in ("e_gate", "e_up", "e_down"))
    log(f"{MOE_MODEL}: {L} layers, d={mc.hidden_size}, heads {mc.num_attention_heads}/{mc.num_key_value_heads} "
        f"(group {mc.num_attention_heads // mc.num_key_value_heads}), head_dim {mc.head_dim}, {E} experts, top-{k}, "
        f"expert width {mc.moe_intermediate_size}, V={mc.vocab_size} untied; {n_all / 1e9:.3f} B parameters, "
        f"{n_all * 2 / 1e9:.2f} GB bf16 ({expert_bytes / 1e9:.2f} GB of experts), drawn in "
        f"{time.perf_counter() - t0:.2f} s; memory allocated {gib(torch.cuda.memory_allocated()):.3f} GiB")
    ec = EngineConfig()
    engine = TreeEngine(mc, ec, device=dev)
    free_engine = TreeEngine(dataclasses.replace(mc, moe_capacity_factor=free_factor), ec, device=dev)
    tree_batch = engine.prepare(TokenTrie(seqs, attachs))
    dense_batch = engine.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=ec.pad_multiple))
    n, n_dense = tree_batch.n_padded, dense_batch.n_padded
    n_dense_tokens = sum(len(s) for s in seqs)
    log(f"{MOE_MODEL}: tree n={n} (capacity {mq.moe_capacity(mc, n)} at the default factor "
        f"{mc.moe_capacity_factor}), dense n={n_dense} (capacity {mq.moe_capacity(mc, n_dense)})")

    # ---- (a) the scoring forward at full depth. At capacity factor E/k no
    # pair drops; the dense replay runs once with the tree's top-k choices
    # (the per-token bar: every other difference is rounding; the model's
    # routing of each layer is held against those choices) and once routing
    # on its own (flips at near-ties move later layers: the sum bar)
    calls = []
    with moe_drops(mq) as rec, moe_routing(mq, "record", calls):
        lp_tree, _, _ = measured("(a) tree forward, capacity factor E/k", lambda: free_engine.forward(
            params, tree_batch), fwd_want(L), profile=False)
    log(drops(rec, f"{MOE_MODEL} (a) tree forward at factor {free_factor:g}", must_be_zero=True))
    chunks = dense_chunks(MOE_DENSE_CHUNK)
    lp_shared, lp_free, stats = {}, {}, {"share": [], "own": []}
    t0 = time.perf_counter()
    with moe_drops(mq) as rec:
        for chunk in chunks:
            batch = dense_batch_of(free_engine, chunk)
            pos_map = torch.from_numpy(tree_rows(tree_batch.packed, batch.packed, chunk)).to(dev)
            with moe_routing(mq, "share", calls, pos_map, stats["share"]):
                out = free_engine.forward(params, batch)
            lp_shared.update({chunk[j]: v for j, v in out.items()})
            with moe_routing(mq, "own", calls, pos_map, stats["own"]):
                out = free_engine.forward(params, batch)
            lp_free.update({chunk[j]: v for j, v in out.items()})
    log(f"{MOE_MODEL} (a) dense replay at factor {free_factor:g} in {len(chunks)} chunks of whole sequences "
        f"(<= {MOE_DENSE_CHUNK} tokens each), with the tree's top-k choices and on its own: "
        f"{time.perf_counter() - t0:.2f} s")
    log(drops(rec, f"{MOE_MODEL} (a) dense replay at factor {free_factor:g}", must_be_zero=True))
    check_logprobs(f"{MOE_MODEL} (a) forward at capacity factor {free_factor:g} (no drops), tree vs dense routed "
                   "by the tree's top-k choices", lp_tree, lp_shared)
    diff = np.concatenate([np.abs(lp_tree[i] - lp_free[i]) for i in sorted(lp_tree)])
    sum_t = sum(float(v.astype(np.float64).sum()) for v in lp_tree.values())
    sum_f = sum(float(v.astype(np.float64).sum()) for v in lp_free.values())
    free_rel = abs(sum_t - sum_f) / abs(sum_f)
    log(f"{MOE_MODEL} (a) tree vs dense routing on its own: summed log-prob rel "
        f"{free_rel:.3e} (tol {TREE_DENSE_SUM_RTOL}); per token mean {diff.mean():.4f}, p99 "
        f"{np.quantile(diff, 0.99):.4f}, p99.9 {np.quantile(diff, 0.999):.4f}, max {diff.max():.4f}, "
        f"{int((diff > TREE_DENSE_TOKEN_ATOL).sum())} tokens past {TREE_DENSE_TOKEN_ATOL} (not gated: a flipped "
        "choice is not a rounding)")
    if free_rel > TREE_DENSE_SUM_RTOL:
        fail(f"{MOE_MODEL} (a) tree vs dense routing on its own: summed log-prob rel {free_rel:.3e}")
    log(flips(f"{MOE_MODEL} (a) dense forward, the tree's routing history", stats["share"], MOE_FLIPS_SHARED))
    log(flips(f"{MOE_MODEL} (a) dense forward routing on its own", stats["own"], MOE_FLIPS_OWN))
    del lp_tree, lp_shared, lp_free, calls, stats
    for label, batch in (("tree", tree_batch), ("dense", dense_batch)):
        with moe_drops(mq) as rec, torch.no_grad():
            _, aux = engine.loss(params, batch)
        log(drops(rec, f"{MOE_MODEL} (a) {label} forward at the default factor {mc.moe_capacity_factor}")
            + f"; lb_loss {float(aux['lb_loss']):.6f} (summed over {L} layers; 1 per layer when balanced)")
    _, _, fwd_tree = measured("(a) tree forward, default factor", lambda: engine.forward(params, tree_batch),
                              fwd_want(L))
    _, _, fwd_dense = measured("(a) dense forward, default factor", lambda: engine.forward(params, dense_batch),
                               fwd_want(L))
    drives[f"{MOE_MODEL} forward path"] = {key: fwd_tree[key] + fwd_dense[key] for key in fwd_tree}
    (t_tree, t_dense), turns = turns_ms(lambda: engine.forward(params, tree_batch),
                                        lambda: engine.forward(params, dense_batch), rounds=2, warm=False)
    log(f"{MOE_MODEL} (a) forward, default factor, in turns (medians of 2): tree {t_tree:.2f} ms, dense "
        f"{t_dense:.2f} ms (speedup {t_dense / t_tree:.3f}), dense-equivalent tokens/s tree "
        f"{n_dense_tokens / t_tree * 1e3:.1f}, dense {n_dense_tokens / t_dense * 1e3:.1f}; tree "
        + " ".join(f"{t:.2f}" for t in turns[0]) + ", dense " + " ".join(f"{t:.2f}" for t in turns[1]))
    free_all()

    # ---- (c) the GRPO rollout at full depth, through the replayed decode step
    P, G = SAMPLER_P, SAMPLER_G
    lens = np.array(SAMPLER_LENS, np.int32)
    rng = np.random.default_rng(0)
    prompts = np.zeros((P, int(lens.max())), np.int32)
    for p_, n_ in enumerate(lens):
        prompts[p_, :n_] = rng.integers(1, mc.vocab_size, size=n_)
    captures = []
    real_captured_step, real_use_graph = gm._captured_step, gm._use_graph

    def counting_capture(*args):
        captures.append(1)
        return real_captured_step(*args)

    gm._captured_step = counting_capture
    try:
        sampled, roll_ms, roll_counts = measured(
            f"(c) rollout, P={P} x G={G}, prompts {'/'.join(map(str, lens))}, max_new={MOE_NEW}, sampled",
            lambda: generate_grouped(params, mc, prompts, lens, G, MOE_NEW,
                                     generator=torch.Generator(device=dev).manual_seed(1)),
            {"decode_attn": L * (MOE_NEW - 1)}, profile=False)
    finally:
        gm._captured_step = real_captured_step
    drives[f"{MOE_MODEL} rollout"] = roll_counts
    distinct = [len({tuple(r) for r in sampled[p_]}) for p_ in range(P)]
    log(f"{MOE_MODEL} (c) rollout: {P * G * MOE_NEW / roll_ms * 1e3:.1f} sampled tokens/s (prefill and capture "
        f"included); captures {len(captures)}; distinct branches per prompt {distinct}")
    if len(captures) != 1 or sampled.shape != (P, G, MOE_NEW) or min(distinct) < 2:
        fail(f"{MOE_MODEL} rollout: {len(captures)} captures, shape {sampled.shape}, distinct {distinct}")
    TNEW = SAMPLER_TIMED_NEW
    replayed = generate_grouped(params, mc, prompts, lens, G, TNEW, greedy=True)
    gm._use_graph = lambda device, backend: False
    try:
        eager = generate_grouped(params, mc, prompts, lens, G, TNEW, greedy=True)
    finally:
        gm._use_graph = real_use_graph
    if not np.array_equal(replayed, eager):
        fail(f"{MOE_MODEL} greedy: the replayed loop's tokens differ from the eager loop's at "
             + str([first_diff(replayed[p_, g], eager[p_, g]) for p_ in range(P) for g in range(G)]))
    log(f"{MOE_MODEL} (c) greedy, max_new={TNEW}: the replayed loop's tokens equal the eager loop's")
    # the decode step alone: one captured greedy step over a prefilled
    # prompt cache, replayed MOE_DECODE_WINDOW times from t = MOE_NEW / 2
    hkv, dh = mc.num_key_value_heads, mc.head_dim
    with torch.inference_mode():
        cache = gm.init_cache(mc, P, prompts.shape[1], bf16, dev)
        gm._prefill(params, mc, prompts, lens, cache["k"], cache["v"])
        ckc, cvc = (torch.zeros((L, P, G, hkv, MOE_NEW, dh), dtype=bf16, device=dev) for _ in range(2))
        layers, plens = gm._layer_list(params), torch.as_tensor(lens, device=dev)

        def step(tok, t):
            return gm._decode_step_grouped(params, mc, tok, plens, t, cache["k"], cache["v"], ckc, cvc, "kernel",
                                           layers=layers)[0]

        sample = gm._sampler(None, 1.0, True, 0, None, None)
        t_lo = MOE_NEW // 2
        state = gm._grouped_state(torch.as_tensor(sampled[:, :, t_lo], device=dev), MOE_NEW, None)

        def run_step():
            gm._grouped_step(step, sample, state, None)

        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream())
        state["t"].fill_(t_lo)
        with torch.cuda.stream(side):
            run_step()
        replay = real_captured_step(run_step, side, None)

        def window():
            state["t"].fill_(t_lo)
            for _ in range(MOE_DECODE_WINDOW):
                replay()

        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3 / MOE_DECODE_WINDOW)
        layers_ms = profile_run(window, f"{MOE_MODEL} decode step, replayed, {MOE_DECODE_WINDOW} steps")
    step_host = float(np.median(ts))
    step_busy = sum(layers_ms.values()) / MOE_DECODE_WINDOW if layers_ms else None
    floor = expert_bytes / PEAK_HBM_BYTES * 1e3
    log(f"{MOE_MODEL} (c) decode step (replayed, greedy, t={t_lo}..{t_lo + MOE_DECODE_WINDOW - 1}): host "
        f"{step_host:.3f} ms (median of 3 windows) vs device busy "
        + ("not measured" if step_busy is None else f"{step_busy:.3f} ms")
        + f" a step; by class a step: " + ", ".join(f"{k_} {v / MOE_DECODE_WINDOW:.3f}" for k_, v in sorted(
            layers_ms.items(), key=lambda kv: -kv[1]))
        + f"; the floor of reading every expert once, {expert_bytes / 1e9:.2f} GB at "
          f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s: {floor:.3f} ms")
    del replay, cache, ckc, cvc, layers, state
    del params, sampled, replayed, eager, tree_batch, dense_batch, engine, free_engine
    free_all()

    # ---- (b) the training step
    pc = layers_of(MOE_PARITY_LAYERS)
    params = init_params(pc, torch.Generator(device=dev).manual_seed(0), bf16)
    free_c = dataclasses.replace(pc, moe_capacity_factor=free_factor, router_aux_coef=0.0)
    f_eng = TreeEngine(free_c, ec, device=dev)
    tree_batch = f_eng.prepare(TokenTrie(seqs, attachs))
    calls = []
    with moe_drops(mq) as rec, moe_routing(mq, "record", calls):
        (loss_t, grads_t, _), _, _ = measured(
            f"(b) {MOE_PARITY_LAYERS}-layer tree step, factor E/k, no lb term",
            lambda: f_eng.loss_and_grad(params, tree_batch), profile=False)
    log(drops(rec, f"{MOE_MODEL} (b) tree step at factor {free_factor:g}", must_be_zero=True))
    grads_t = {name: g.cpu() for name, g in named_leaves(grads_t)}  # kept on the host

    def grad_rels(acc):
        rels = []
        for name, g_d in acc.items():
            stacked = g_d.ndim >= 2 and "layers" in name
            for i in range(g_d.shape[0] if stacked else 1):
                gd_, gt_ = (g_d[i], grads_t[name][i]) if stacked else (g_d, grads_t[name])
                gd_, gt_ = gd_.double(), gt_.to(dev).double()
                rels.append((float(torch.linalg.vector_norm(gt_ - gd_)
                                   / torch.linalg.vector_norm(gd_).clamp(min=1e-30)), f"{name}[{i}]"))
        return sorted(rels, reverse=True)

    t0 = time.perf_counter()
    chunks = dense_chunks(MOE_DENSE_CHUNK // 2)
    summed, stats = {}, {"share": [], "own": []}
    with moe_drops(mq) as rec:
        for routing in ("share", "own"):
            acc, loss_sum = None, 0.0
            for chunk in chunks:
                batch = dense_batch_of(f_eng, chunk)
                pos_map = torch.from_numpy(tree_rows(tree_batch.packed, batch.packed, chunk)).to(dev)
                with moe_routing(mq, routing, calls, pos_map, stats[routing]):
                    loss_c, grads_c, _ = f_eng.loss_and_grad(params, batch)
                loss_sum += float(loss_c)
                if acc is None:
                    acc = {name: g.float() for name, g in named_leaves(grads_c)}
                else:
                    for name, g in named_leaves(grads_c):
                        acc[name] += g
                del grads_c
            summed[routing] = (loss_sum, grad_rels(acc))
            del acc
    log(f"{MOE_MODEL} (b) dense replay steps at factor {free_factor:g} in {len(chunks)} chunks of whole sequences "
        f"(<= {MOE_DENSE_CHUNK // 2} tokens), grads summed in fp32, with the tree's top-k choices and on its own: "
        f"{time.perf_counter() - t0:.2f} s")
    log(drops(rec, f"{MOE_MODEL} (b) dense replay steps at factor {free_factor:g}", must_be_zero=True))

    own_loss, own_rels = summed.pop("own")
    own_rel = abs(float(loss_t) - own_loss) / abs(own_loss)
    log(f"{MOE_MODEL} (b) training tree vs dense routing on its own: loss rel {own_rel:.3e} (tol {STEP_LOSS_RTOL}), "
        f"grad rel err max {own_rels[0][0]:.4e} (not gated: a flipped choice moves its router and expert grads), "
        f"median {float(np.median([r for r, _ in own_rels])):.4e}; worst 3: "
        + ", ".join(f"{name} {r:.3e}" for r, name in own_rels[:3]))
    if not own_rel <= STEP_LOSS_RTOL:
        fail(f"{MOE_MODEL} (b) tree vs dense routing on its own: loss rel {own_rel:.3e}")
    log(flips(f"{MOE_MODEL} (b) dense steps (forwards and recomputes), the tree's routing history",
              stats["share"], MOE_FLIPS_SHARED))
    log(flips(f"{MOE_MODEL} (b) dense steps routing on their own", stats["own"], MOE_FLIPS_OWN))
    loss_d, rels = summed.pop("share")
    loss_rel = abs(float(loss_t) - loss_d) / abs(loss_d)
    log(f"{MOE_MODEL} (b) training tree vs dense routed by the tree's top-k choices, factor {free_factor:g}, no lb "
        f"term: loss {float(loss_t):.6f} "
        f"vs {loss_d:.6f} (rel {loss_rel:.3e}, tol {STEP_LOSS_RTOL}); {len(rels)} params, grad rel err max "
        f"{rels[0][0]:.4e}, median {float(np.median([r for r, _ in rels])):.4e} (tol {STEP_GRAD_REL}); worst 5: "
        + ", ".join(f"{name} {r:.3e}" for r, name in rels[:5]))
    if not (math.isfinite(loss_rel) and all(math.isfinite(r) for r, _ in rels)):
        fail(f"{MOE_MODEL} (b) tree vs dense: non-finite loss or gradients")
    if loss_rel > STEP_LOSS_RTOL or rels[0][0] > STEP_GRAD_REL:
        fail(f"{MOE_MODEL} (b) tree vs dense: outside the bars")
    del grads_t, f_eng, calls, stats
    free_all()
    split = TreeEngine(pc, dataclasses.replace(ec, bwd_mode="split"), device=dev)
    _build.reset_launches()
    first = split.loss_and_grad(params, tree_batch)
    split_counts = _build.launches()
    second = split.loss_and_grad(params, tree_batch)
    same = (torch.equal(first[0], second[0]) and torch.equal(first[2]["lb_loss"], second[2]["lb_loss"])
            and all(torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(first[1]), named_leaves(second[1]))))
    log(f"{MOE_MODEL} (b) two {MOE_PARITY_LAYERS}-layer bwd_mode=\"split\" steps (default factor, lb term on): "
        f"loss {float(first[0]):.6f}, lb_loss {float(first[2]['lb_loss']):.6f}, bit-equal: {same}; launches "
        f"{by_id(split_counts)}")
    if not same:
        fail(f"{MOE_MODEL}: two split steps are not bit-equal")
    drives[f"{MOE_MODEL} split step"] = split_counts
    del first, second, split
    # one MoE layer, forward and backward, under the sync check
    lp0 = {name: w[0].detach().requires_grad_() for name, w in params["layers"].items()}
    attn = TreeEngine(pc, ec, device=dev)._attn_fn(tree_batch)
    gen = torch.Generator(device=dev).manual_seed(4)
    x0 = torch.randn(n, mc.hidden_size, generator=gen, device=dev).to(bf16).requires_grad_()
    cos, sin = mq.rope_tables(tree_batch.depth, mc.head_dim, mc.rope_theta, mc.rope_scaling_tuple)
    cot = torch.randn(n, mc.hidden_size, generator=gen, device=dev).to(bf16)

    def one_layer():
        y, lb = mq._layer(x0, lp0, cos, sin, pc, attn, fused_qk=True, valid=tree_batch.valid)
        return torch.autograd.grad(torch.sum(y.float() * cot.float()) + lb, [x0, *lp0.values()])

    one_layer()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads_l = one_layer()
    except RuntimeError as err:
        fail(f"one MoE layer (forward + backward) synchronised with the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not all(torch.isfinite(g_.float()).all() for g_ in grads_l):
        fail("one MoE layer's gradients are not finite")
    log(f"{MOE_MODEL} (b) one MoE layer forward + backward (routing, capacity dispatch, expert products, "
        f"combine, lb loss; the engine's attention and qk-prep kernels) under "
        f"torch.cuda.set_sync_debug_mode(\"error\"): no host synchronisation")
    del lp0, grads_l, x0, cot, attn, params
    free_all()
    sc = layers_of(MOE_STEP_LAYERS)
    params = init_params(sc, torch.Generator(device=dev).manual_seed(0), bf16)
    s_eng = TreeEngine(sc, ec, device=dev)
    dense_batch = s_eng.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=ec.pad_multiple))
    log(f"{MOE_MODEL} (b) {MOE_STEP_LAYERS} layers: {n_params(params) / 1e9:.3f} B parameters, "
        f"{gib(torch.cuda.memory_allocated()):.3f} GiB allocated")
    want = step_counts("cached", MOE_STEP_LAYERS)
    want = {"tree_attn_fwd_bound": want.pop("fwd"), **want}
    with moe_drops(mq) as rec:
        (loss, grads, aux), _, step_tree = measured(f"(b) {MOE_STEP_LAYERS}-layer tree step (default)",
                                                    lambda: s_eng.loss_and_grad(params, tree_batch), want,
                                                    profile=False)
    nz = {name: float(grads["layers"][name].float().abs().max()) for name in ("router", "e_gate", "e_up", "e_down")}
    log(drops(rec, f"{MOE_MODEL} (b) default tree step", layers=MOE_STEP_LAYERS)
        + f"; loss {float(loss):.6f}, lb_loss {float(aux['lb_loss']):.6f} (x router_aux_coef "
          f"{mc.router_aux_coef} in the loss); max|grad| {json.dumps(nz)}")
    if not math.isfinite(float(loss)) or min(nz.values()) <= 0:
        fail(f"{MOE_MODEL} default step: loss {float(loss)}, max|grad| {nz}")
    del loss, grads, aux
    _, _, step_dense = measured(f"(b) {MOE_STEP_LAYERS}-layer dense step (default)",
                                lambda: s_eng.loss_and_grad(params, dense_batch), want, profile=False)
    drives[f"{MOE_MODEL} training path"] = {key: step_tree[key] + step_dense[key] for key in step_tree}
    (t_tree, t_dense), turns = turns_ms(lambda: s_eng.loss_and_grad(params, tree_batch),
                                        lambda: s_eng.loss_and_grad(params, dense_batch), rounds=2, warm=False)
    layers_ms = profile_run(lambda: s_eng.loss_and_grad(params, tree_batch),
                            f"{MOE_MODEL} {MOE_STEP_LAYERS}-layer tree step")
    log(f"{MOE_MODEL} (b) {MOE_STEP_LAYERS}-layer training step, in turns (medians of 2): tree {t_tree:.2f} ms, "
        f"dense {t_dense:.2f} ms (speedup {t_dense / t_tree:.3f}); tree device busy "
        + (f"{sum(layers_ms.values()):.2f} ms" if layers_ms else "not measured") + "; tree "
        + " ".join(f"{t:.2f}" for t in turns[0]) + ", dense " + " ".join(f"{t:.2f}" for t in turns[1]))
    del params, s_eng, dense_batch
    free_all()

    # ---- (d) the Trainer
    tc_ = layers_of(MOE_TRAINER_LAYERS)
    tr = Trainer(tc_, EngineConfig(), TrainConfig(param_dtype="bf16", grad_clip=1.0, learning_rate=TRAINER_LR),
                 device=dev)
    tr.init(seed=0)
    n_tokens = int(sum(len(s) for s in seqs))
    losses = []
    for i in range(3):
        stacked, tries = tr.prepare_step(seqs, attachs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec_ = tr.run_step(stacked, tries, len(seqs), n_tokens)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _build.launches()
        drives[f"{MOE_MODEL} trainer step {i + 1}"] = counts
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        losses.append(rec_["loss"])
        log(f"{MOE_MODEL} (d) Trainer ({MOE_TRAINER_LAYERS} layers, AdamW, clip 1.0) step {i + 1}: loss "
            f"{rec_['loss']:.6f}, {ms:.1f} ms, peak {gib(torch.cuda.max_memory_allocated()):.3f} GiB, host "
            f"synchronisations {len(syncs)}, launches {by_id(counts)}")
        if len(syncs) != 1:
            fail(f"{MOE_MODEL} Trainer step {i + 1}: {len(syncs)} host synchronisations, expected one")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{MOE_MODEL} Trainer losses {losses}")
    del tr, stacked
    free_all()

    # ---- (e) the HF bridge: write, load bit-equal, cli.run --ckpt
    name_hf = f"{MOE_MODEL}-{MOE_HF_LAYERS}layers"
    MODEL_CONFIGS[name_hf] = hc = layers_of(MOE_HF_LAYERS)
    params = init_params(hc, torch.Generator(device=dev).manual_seed(0), bf16)  # cli.run's --seed 0 weights
    try:
        with tempfile.TemporaryDirectory() as tmp:
            sd = to_hf_state_dict(params, hc)
            names = list(sd)
            t0 = time.perf_counter()
            size = sum(write_safetensors(os.path.join(tmp, f"model-{s + 1:05d}-of-00002.safetensors"),
                                         {name: sd[name] for name in names[s::2]}) for s in range(2))
            write_s = time.perf_counter() - t0
            del sd
            t0 = time.perf_counter()
            back = load_hf_checkpoint(tmp, hc, bf16, dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            same = all(a.dtype == b.dtype and a.shape == b.shape and a.stride() == b.stride() and torch.equal(a, b)
                       for (_, a), (_, b) in zip(named_leaves(back), named_leaves(params)))
            same = same and [x for x, _ in named_leaves(back)] == [x for x, _ in named_leaves(params)]
            log(f"{MOE_MODEL} (e) HF bridge, {MOE_HF_LAYERS} layers ({len(names)} tensors, {size / 1e9:.3f} GB in 2 "
                f"safetensors shards): written in {write_s:.2f} s, loaded through load_hf_checkpoint in "
                f"{load_s:.2f} s, bit-equal to the written params (values, dtypes, layouts): {same}")
            if not same:
                fail(f"{MOE_MODEL}: the HF round trip is not bit-equal")
            del back
            argv = ["--model", name_hf, "--device", DEVICE, "--run", "tree_forward", "--iters", "1",
                    "--data", "synthetic:n_prompts=1,samples=8,prompt_lo=512,prompt_hi=1024,completion_lo=64,"
                              "completion_hi=256"]
            records = []
            _build.reset_launches()
            for extra in (["--ckpt", tmp], ["--seed", "0"]):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    cli_run.main(argv + extra)
                records.append(json.loads([x for x in out.getvalue().splitlines() if x.startswith("{")][-1]))
            counts = _build.launches()
            log(f"{MOE_MODEL} (e) cli.run --ckpt: {json.dumps(records[0])}; the same run from the weights in "
                f"memory (--seed 0): sum_logprobs {records[1]['sum_logprobs']!r}; launches of both {by_id(counts)}")
            if records[0]["sum_logprobs"] != records[1]["sum_logprobs"] or not math.isfinite(
                    records[0]["sum_logprobs"]):
                fail(f"{MOE_MODEL}: cli.run --ckpt gives {records[0]['sum_logprobs']!r}, the weights in memory "
                     f"{records[1]['sum_logprobs']!r}")
    finally:
        del MODEL_CONFIGS[name_hf]
    del params
    free_all()
    return drives


# Phase 11: data, tensor, vocab and expert parallelism over torch.distributed,
# ranks sharing the one card over gloo with CUDA tensors (NCCL refuses two
# ranks of one communicator on one device). Each rank is a fresh process
# (this script with --parallel-rank); the kernels were built in phase 1, so
# no rank compiles. The card shows correctness only: ranks that share it
# share its SMs and memory, so no time here is a scaling number.
PARALLEL_WORLD = 4
PARALLEL_TIMEOUT_S = 600
# K8 / K9 on the vocabulary shard of Qwen3-0.6B at tp = 2 (151936 / 2 =
# 75968 columns: 296.75 of the kernels' 256-column tiles, the last ragged),
# at this many rows
VP_ROWS = 2048
# (c)'s rollouts: at factor E/k the all-to-all sends C = 64 n pairs to each
# rank (JAX's capacity), 2 · 64 n · d bf16 bytes a block out and as much
# back, all through host memory under gloo; short sequences keep it to a
# few seconds
MOE_EP_DATA = dict(seed=0, n_prompts=1, samples_per_prompt=4, prompt_len=(192, 256), completion_len=(64, 128),
                   branch_prob=0.85)


def parallel_cli_argv() -> list:
    """(d)'s ``cli.train`` flags, shared by the ranks' --dp 2 --tp 2 run and
    the parent's --dp 1 runs."""
    return ["--model", MODEL, "--device", DEVICE, "--data", CKPT_DATA, "--lr", str(TRAINER_LR)]


def _bin_tries(seqs, attachs, dp: int):
    """dp tries of the sequences split by token count (LB_by_n_tokens)."""
    from dynamictreeattn_tpu_torch.parallel import LB_by_n_tokens
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    bins = LB_by_n_tokens(seqs, dp)
    return [TokenTrie([seqs[i] for i in ids], [attachs[i] for i in ids]) for ids in bins]


def _leaf_rels(got: dict, ref: dict) -> list:
    """[(rel err, name)] per leaf (per layer for stacked leaves), worst first."""
    from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

    refs = dict(named_leaves(ref))
    rels = []
    for name, g in named_leaves(got):
        r = refs[name]
        stacked = g.ndim >= 2 and "layers" in name
        for i in range(g.shape[0] if stacked else 1):
            gi, ri = (g[i], r[i]) if stacked else (g, r)
            rels.append((float(torch.linalg.vector_norm(gi.double() - ri.double())
                               / torch.linalg.vector_norm(ri.double()).clamp(min=1e-30)), f"{name}[{i}]" if stacked
                         else name))
    return sorted(rels, reverse=True)


def flips_summary(stats, k: int, limits) -> tuple[str, bool]:
    """``moe_routing`` stats as phase 10 reads them: (text, past the
    limits): the share of real (token, layer) choices whose top-k set
    differs from the recorded one, their gaps, rows routed against valid."""
    n_real = int(sum(int(r.sum()) for r, _, _, _ in stats))
    n_bad = int(sum(int(b) for _, _, _, b in stats))
    gaps = torch.cat([g[f] for _, f, g, _ in stats]).cpu().double().numpy() if stats else np.zeros(0)
    share = gaps.size / max(n_real, 1)
    text = (f"(token, layer) choices whose top-{k} set differs {gaps.size} of {n_real} ({share:.4e}, limit "
            f"{limits[0]}); their gap " + (f"max {gaps.max():.4e} nats" if gaps.size else "none")
            + f" (limit {limits[1]}); rows routed against valid {n_bad}")
    return text, bool(n_bad or share > limits[0] or (gaps.size and gaps.max() > limits[1]))


def parallel_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 11 (``--parallel-rank RANK WORLD DIR``): (a) dp = 2,
    (b) tp = 2 and dp = 2 x tp = 2, (d) ``cli.train --dp 2 --tp 2`` and its
    checkpoint, (c) ep = 2 at Qwen3-30B-A3B's width; writes its results to
    DIR/rank<RANK>.json."""
    import collections
    import datetime
    import gc
    import hashlib
    import warnings

    t_entry = time.perf_counter()

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamictreeattn_tpu_torch.cli import train as cli_train
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
    from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten, _unflatten
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.models import qwen3 as mq
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.parallel import (
        make_mesh, make_train_step, shard_params, stack_batches, tp_model,
    )
    from dynamictreeattn_tpu_torch.parallel import collectives as coll
    from dynamictreeattn_tpu_torch.tries import TokenTrie, build_kmajor_work
    import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module, not the function)
    ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"drives": {}, "ms": {}, "sections_s": {}}
    bf16 = torch.bfloat16
    t_section = t_entry

    def section_done(name: str):
        nonlocal t_section
        now = time.perf_counter()
        out["sections_s"][name] = now - t_section
        t_section = now

    # every collective goes through collectives._call: count and time them
    # (the call returns when gloo has finished; the card is synchronised
    # first, so a collective's ms is its own)
    coll_stats = collections.defaultdict(lambda: [0, 0.0])
    real_call = coll._call

    def timed_call(name, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_call(name, *args, **kwargs)
        coll_stats[name][0] += 1
        coll_stats[name][1] += (time.perf_counter() - t0) * 1e3

    coll._call = timed_call

    def measured(label: str, run, mesh=None):
        """run() with launch counts from 0 and the collectives' tally:
        (result, counts); records host ms and collective ms. With `mesh`,
        its ranks start together (a barrier), so that no rank's collective
        ms holds another rank's lag in building its reference."""
        torch.cuda.synchronize()
        if mesh is not None:
            dist.barrier(group=mesh.everyone)
        _build.reset_launches()
        coll_stats.clear()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _build.launches()
        c_ms = sum(v[1] for v in coll_stats.values())
        out["ms"][label] = {"step_ms": ms, "collective_ms": c_ms,
                            "collectives": {k: v[0] for k, v in coll_stats.items()}}
        return res, counts

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def one_device_sum(cfg, ec, packeds, prm, own: int, label: str, keep=None, routing=None):
        """The one-device steps on every bin, run on this rank and summed in
        rank order, as a sum over the ranks adds them: (loss, grads, the
        launches of this rank's own bin's step, measured as `label`). The
        reference needs no collective of its own. `keep(grads)` cuts each
        bin's grads before the sum (this rank's experts); `routing` records
        the own bin's routing (``moe_routing``)."""
        eng = TreeEngine(cfg, ec, device=dev)
        loss, held, counts = None, None, None
        for i, packed in enumerate(packeds):
            tb = eng.prepare(packed)  # the bin padded to the common bucket, as the step's
            with (moe_routing(mq, "record", routing) if routing is not None and i == own
                  else contextlib.nullcontext()):
                if i == own:
                    (l_i, g_i, _), counts = measured(label, lambda: eng.loss_and_grad(prm, tb))
                else:
                    l_i, g_i, _ = eng.loss_and_grad(prm, tb)
            g_i = keep(g_i) if keep else g_i
            leaves = _flatten(g_i)[1]
            loss = l_i if loss is None else loss + l_i
            for a, b in zip(held or (), leaves):
                b += a.to(b.device)  # the earlier bins' sum and this bin's: one IEEE add, either order
            if i < len(packeds) - 1:
                # the running sum waits in host memory while the next bin's
                # step runs: the 30B model's steps leave no room for it
                held = [t.cpu() for t in leaves]
                del g_i
            del tb, leaves
            free()
        return loss, g_i, counts

    section_done("start (imports, process group)")
    mc = MODEL_CONFIGS[MODEL]
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
                                            completion_len=(128, 512), branch_prob=0.85)
    params = init_params(mc, torch.Generator(device=dev).manual_seed(0), bf16)

    # ---- (a) dp = 2: each rank trains its bin; grads summed over "data"
    mesh = make_mesh(dp=2, tp=1, backend="gloo", device=DEVICE)
    if mesh is not None:
        r = mesh.rank("data")
        tries = _bin_tries(seqs, attachs, 2)
        for mode in ("split", "auto"):
            ec = EngineConfig(bwd_mode=mode)
            step = make_train_step(mc, ec, mesh=mesh)
            batch = stack_batches(tries, ec, engine=step.engine, mesh=mesh)
            ref_loss, ref, c_one = one_device_sum(mc, ec, batch.packeds, params, r,
                                                  f"(a) one-device step on bin {r}, {mode}")
            (loss_m, grads_m, _), c_mesh = measured(f"(a) dp=2 step, {mode}", lambda: step(params, batch), mesh)
            if c_mesh != c_one:
                fail(f"(a) rank {rank} {mode}: the dp step launched {by_id(c_mesh)}, its bin's one-device step "
                     f"{by_id(c_one)}")
            out["drives"][f"parallel (a) dp=2 step {mode}, rank {rank}"] = c_mesh
            if mode == "split":
                same = torch.equal(loss_m, ref_loss) and all(
                    torch.equal(a, b) for a, b in zip(_flatten(grads_m)[1], _flatten(ref)[1]))
                log(f"(a) rank {rank}: dp=2 bwd_mode=\"split\" step (bin of {batch.packeds[r].n_padded} padded "
                    f"tokens): loss {float(loss_m):.6f}, the sum of the two one-device steps {float(ref_loss):.6f}; "
                    f"loss and all {len(_flatten(ref)[1])} grads bit-equal: {same}; launches {by_id(c_mesh)} "
                    "(= its bin's one-device step)")
                if not same:
                    fail(f"(a) rank {rank}: the split dp step is not bit-equal to the summed one-device steps")
            else:
                check_step(f"(a) rank {rank}: dp=2 step (\"auto\") vs the summed one-device steps",
                           (loss_m, grads_m, None), (ref_loss, ref, None))
            del step, batch, grads_m, ref
            free()
    section_done("(a)")

    # ---- (b) tp = 2 (ranks 0, 1), then dp = 2 x tp = 2 (all four)
    for dp, tp in ((1, 2), (2, 2)):
        mesh = make_mesh(dp=dp, tp=tp, backend="gloo", device=DEVICE)
        if mesh is None:
            continue
        label = f"tp=2" if dp == 1 else "dp=2 x tp=2"
        r = mesh.rank("data")
        tries = _bin_tries(seqs, attachs, dp) if dp > 1 else [TokenTrie(seqs, attachs)]
        ec = EngineConfig()
        step = make_train_step(mc, ec, mesh=mesh)
        batch = stack_batches(tries, ec, engine=step.engine, mesh=mesh)
        tb = batch.batches[0]
        hkv = mc.num_key_value_heads // tp
        meta = [m.cpu().numpy() for m in tb.meta[3:6]]
        local_work = build_kmajor_work(tb.last_desc.cpu().numpy(), *meta, ec.block_q, ec.block_kv, hkv,
                                       ta.kmajor_slots(dev, mc.head_dim), tile=ta.KERNEL_TILE)
        if (tb.kmajor_work.bound, len(tb.kmajor_work.chunks)) != (local_work.bound, len(local_work.chunks)):
            fail(f"(b) {label}: the batch's key-major work list was not built for the {hkv} local kv heads")
        ref_loss, ref, c_one = one_device_sum(mc, ec, batch.packeds, params, r,
                                              f"(b) {label} one-device step on bin {r}")
        ref = shard_params(ref, mesh, mc)
        local = shard_params(params, mesh, mc)
        (loss_m, grads_m, _), c_mesh = measured(f"(b) {label} step", lambda: step(local, batch), mesh)
        shard = local["embed"].shape[0]
        log(f"(b) rank {rank}, {label}: local heads {mc.num_attention_heads // tp} q / {hkv} kv, vocabulary shard "
            f"{shard} rows (K8 / K9 on it), work list bound {tb.kmajor_work.bound} in {len(tb.kmajor_work.chunks)} "
            f"chunks (local kv heads); launches {by_id(c_mesh)}")
        if shard != mc.vocab_size // tp or c_mesh != c_one:
            fail(f"(b) {label}: vocabulary shard {shard}, launches {by_id(c_mesh)} vs the one-device step's "
                 f"{by_id(c_one)}")
        check_step(f"(b) rank {rank}: {label} step vs the one-device step (its shards)", (loss_m, grads_m, None),
                   (ref_loss, ref, None))
        out["drives"][f"parallel (b) {label} step, rank {rank}"] = c_mesh
        if dp == 1:
            # one TP layer forward + backward under the sync check; each
            # collective runs under "warn", and whether it synchronised is
            # recorded (gloo stages CUDA tensors through the host)
            lp0 = {name: w[0].detach().requires_grad_() for name, w in local["layers"].items()}
            gen = torch.Generator(device=dev).manual_seed(4)
            x0 = torch.randn(tb.n_padded, mc.hidden_size, generator=gen, device=dev).to(bf16).requires_grad_()
            cot = torch.randn(tb.n_padded, mc.hidden_size, generator=gen, device=dev).to(bf16)
            cos, sin = mq.rope_tables(tb.depth, mc.head_dim, mc.rope_theta, mc.rope_scaling_tuple)
            attn = step.engine._attn_fn(tb)
            lc = tp_model.local_config(mc, tp)
            synced = collections.Counter()

            def warned_call(name, *args, **kwargs):
                torch.cuda.set_sync_debug_mode("warn")
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    real_call(name, *args, **kwargs)
                torch.cuda.set_sync_debug_mode("error")
                synced[(name, any("synchroniz" in str(w.message) for w in caught))] += 1

            def one_layer():
                y, _ = tp_model._layer_tp(x0, lp0, cos, sin, lc, attn, fused_qk=True, mesh=mesh)
                return torch.autograd.grad(torch.sum(y.float() * cot.float()), [x0, *lp0.values()])

            one_layer()
            torch.cuda.synchronize()
            coll._call = warned_call
            torch.cuda.set_sync_debug_mode("error")
            try:
                grads_l = one_layer()
            except RuntimeError as err:
                fail(f"(b) one TP layer synchronised with the host outside a collective: {err}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
                coll._call = timed_call
            if not all(torch.isfinite(g.float()).all() for g in grads_l):
                fail("(b) one TP layer's gradients are not finite")
            log(f"(b) rank {rank}: one TP layer forward + backward (K4/K5, K1, K3, K6/K7 on {lc.num_attention_heads} "
                f"q / {lc.num_key_value_heads} kv local heads) "
                "under torch.cuda.set_sync_debug_mode(\"error\") outside its collectives: no host synchronisation; "
                "its collectives, each run under \"warn\" (name, flagged by the check): "
                + ", ".join(f"{name} {s} x{n}" for (name, s), n in sorted(synced.items())))
            del lp0, x0, cot, grads_l, attn
        del step, batch, tb, ref, grads_m, local
        free()
        section_done(f"(b) {label}")
        if dp == 2:
            # (d) cli.train --dp 2 --tp 2 in this process group (it joins it, as
            # under torchrun): 2 steps and a checkpoint gathered to one file;
            # the hashes of this rank's shards (params and moments) after them,
            # for a one-device restore to reproduce bit for bit
            ckpt, stats_out = os.path.join(workdir, "cli_ckpt"), os.path.join(workdir, "cli.jsonl")
            tr, c_tr = measured("(d) cli.train --dp 2 --tp 2: 2 steps and the save", lambda: cli_train.main(
                parallel_cli_argv() + ["--steps", "2", "--dp", "2", "--tp", "2", "--dist-backend", "gloo",
                                       "--ckpt-dir", ckpt, "--stats-out", stats_out]))
            out["drives"][f"parallel (d) cli.train dp=2 x tp=2, 2 steps, rank {rank}"] = c_tr

            def digest(t):
                return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

            out["hashes"] = {"params": [digest(t) for t in _flatten(tr.params)[1]],
                             "mu": [digest(t) for t in tr.opt_state["mu"]],
                             "nu": [digest(t) for t in tr.opt_state["nu"]]}
            log(f"(d) rank {rank}: cli.train --dp 2 --tp 2 losses {[x['loss'] for x in tr.history]}, saved a "
                f"gathered checkpoint of step {tr.step_idx}")
            if not all(math.isfinite(x["loss"]) for x in tr.history):
                fail("(d) cli.train's loss at 2 x 2 is not finite")
            del tr
            free()
            section_done("(d) cli.train 2 x 2")
    del params
    free()

    # ---- (c) ep = 2 at Qwen3-30B-A3B's width, MOE_PARITY_LAYERS layers, on
    # the first four sequences' trie split in two bins
    mmc = dataclasses.replace(MODEL_CONFIGS[MOE_MODEL], num_hidden_layers=MOE_PARITY_LAYERS)
    E, k = mmc.num_experts, mmc.num_experts_per_tok
    mesh = make_mesh(dp=2, tp=1, backend="gloo", device=DEVICE)
    if mesh is not None:
        r = mesh.rank("data")
        small = _bin_tries(*synthetic_rollout_batch(**MOE_EP_DATA), 2)
        full = init_params(mmc, torch.Generator(device=dev).manual_seed(0), bf16)
        local, calls, ref = None, [], None
        drops = []  # per MoE block run: ("send", real pairs, sent) at the dispatch; ("expert", pairs, dropped)
        real_dispatch, real_apply = tp_model.ep_dispatch, tp_model.moe_apply

        def dispatch(idx, *args):
            res = real_dispatch(idx, *args)
            drops.append(("send", (idx < E).sum(), res[1].sum()))
            return res

        def apply(h, g, u, d, idx, w, cap):
            flat = idx.reshape(-1)
            hit = (flat >= 0) & (flat < g.shape[0])
            counts = torch.zeros(g.shape[0] + 1, dtype=torch.int64, device=idx.device).scatter_add_(
                0, torch.where(hit, flat, g.shape[0]).long(), torch.ones_like(flat, dtype=torch.int64))[:-1]
            drops.append(("expert", counts.sum(), (counts - cap).clamp(min=0).sum()))
            return real_apply(h, g, u, d, idx, w, cap)

        for factor in (float(E // k), mmc.moe_capacity_factor):
            no_drop = factor != mmc.moe_capacity_factor
            cfg = dataclasses.replace(mmc, moe_capacity_factor=factor)
            ec = EngineConfig()
            step = make_train_step(cfg, ec, mesh=mesh, ep=True)
            batch = stack_batches(small, ec, engine=step.engine, mesh=mesh)
            n = batch.packeds[r].n_padded
            C, cap_local = tp_model.ep_capacity(cfg, n, 2)
            if no_drop:
                half = E // 2

                def mine(g):  # this rank's experts of one bin's grads, as shard_params(ep=2) holds them
                    for name in ("e_gate", "e_up", "e_down"):
                        g["layers"][name] = g["layers"][name][:, r * half:(r + 1) * half].clone()
                    return g

                ref_loss, ref, c_one = one_device_sum(cfg, ec, batch.packeds, full, r, "(c) one-device step",
                                                      keep=mine, routing=calls)
                local = shard_params(full, mesh, cfg, ep=2)
                del full
                free()
            drops.clear()
            stats = []
            tp_model.ep_dispatch, tp_model.moe_apply = dispatch, apply
            try:
                if no_drop:
                    with moe_routing(tp_model, "own", calls, torch.arange(n, device=dev), stats):
                        (loss_m, grads_m, aux_m), c_mesh = measured("(c) ep=2 step, factor E/k",
                                                                    lambda: step(local, batch), mesh)
                else:
                    (loss_m, grads_m, aux_m), c_mesh = measured("(c) ep=2 step, default factor",
                                                                lambda: step(local, batch), mesh)
            finally:
                tp_model.ep_dispatch, tp_model.moe_apply = real_dispatch, real_apply
            rows = [(kind, int(a), int(b)) for kind, a, b in drops]
            sent = [a - b for kind, a, b in rows if kind == "send"]
            at_experts = [b for kind, a, b in rows if kind == "expert"]
            held = local["layers"]["e_gate"].shape[1]
            a2a = 2 * (2 * C) * mmc.hidden_size * 2 + 2 * C * 8  # rows out and back (bf16), expert ids (int64)
            log(f"(c) rank {rank}, factor {factor:g}: {held} of {E} experts held; n {n}, C {C} pairs to each "
                f"rank, local capacity {cap_local}; {len(sent)} MoE blocks run (forward and recompute); pairs "
                f"dropped at the dispatch per block {sent}, at the experts {at_experts}; all-to-all bytes sent per "
                f"MoE block forward per rank {a2a} (the backward exchanges as much again); loss "
                f"{float(loss_m):.6f}, lb_loss {float(aux_m['lb_loss']):.6f}; launches {by_id(c_mesh)}")
            nz = {name: float(grads_m["layers"][name].float().abs().max()) for name in ("e_gate", "e_up", "e_down")}
            if held != E // 2 or not math.isfinite(float(loss_m)) or min(nz.values()) <= 0:
                fail(f"(c) rank {rank}: {held} experts held, loss {float(loss_m)}, expert max|grad| {nz}")
            if no_drop:
                if sum(sent) or sum(at_experts):
                    fail(f"(c) rank {rank}: pairs dropped at factor E/k")
                if c_mesh != c_one:
                    fail(f"(c) rank {rank}: the ep step launched {by_id(c_mesh)}, the one-device step {by_id(c_one)}")
                out["drives"][f"parallel (c) ep=2 step, rank {rank}"] = c_mesh
                text, bad = flips_summary(stats, k, MOE_FLIPS_OWN)
                log(f"(c) rank {rank}: the ep step's routing against its bin's one-device step's: {text}")
                if bad:
                    fail(f"(c) rank {rank}: routing flips past the limits")
                # a flipped choice on either rank moves the router's grads and
                # the experts' (each rank's experts take both ranks' rows): they
                # are gated when no choice flipped on either rank
                flipped = torch.tensor([float(sum(int(f.sum()) for _, f, _, _ in stats))], device=dev)
                dist.all_reduce(flipped, group=mesh.group("data"))
                rels = _leaf_rels(grads_m, ref)
                gated = rels if not flipped.item() else [(x, nm) for x, nm in rels
                                                         if "'e_" not in nm and "router" not in nm]
                loss_rel = abs(float(loss_m) - float(ref_loss)) / abs(float(ref_loss))
                log(f"(c) rank {rank}: ep=2 step vs the summed one-device steps, factor E/k: loss rel "
                    f"{loss_rel:.3e} (tol {STEP_LOSS_RTOL}); choices flipped on both ranks {int(flipped.item())}; "
                    f"grad rel err max {gated[0][0]:.4e} over the gated leaves ("
                    + ("all" if len(gated) == len(rels) else "all but the router and the experts")
                    + f"; tol {STEP_GRAD_REL}), {rels[0][0]:.4e} over all; worst 3: "
                    + ", ".join(f"{nm} {x:.3e}" for x, nm in rels[:3]))
                if loss_rel > STEP_LOSS_RTOL or gated[0][0] > STEP_GRAD_REL:
                    fail(f"(c) rank {rank}: the ep step is outside the bars")
                ref = None
            else:
                if not sum(sent) + sum(at_experts):
                    log(f"(c) rank {rank}: no pair dropped at the default factor")
                out["drops_default"] = {"dispatch": sent, "experts": at_experts}
            del step, batch, grads_m
            free()
        del local
        free()
        section_done("(c)")
    out["sections_s"]["whole rank"] = time.perf_counter() - t_entry
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    coll._call = real_call
    dist.barrier()
    dist.destroy_process_group()


def parallel_phase(dev) -> dict:
    """Phase 11 in the parent: K8 / K9 against their plain versions on the
    vocabulary shard of tp = 2; the ranks (``parallel_rank``, PARALLEL_WORLD
    fresh processes on the one card, their logs printed here); the
    checkpoint their ``cli.train --dp 2 --tp 2`` wrote, restored on one
    device and cut again into each rank's shards, bit-equal to what each
    rank held; that run's step 1 against ``cli.train --dp 1``, and its
    checkpoint resumed at ``--dp 1``. Returns the ranks' drives {name:
    launches} summed over the ranks, cli.train --dp 1's step-1 loss and the
    losses of the ranks' cli.train --dp 2 --tp 2."""
    import gc
    import hashlib
    import shutil
    import tempfile

    from dynamictreeattn_tpu_torch.cli import train as cli_train
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.ops.lm_stats import lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain
    from dynamictreeattn_tpu_torch.parallel import Mesh, shard_params
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer
    from dynamictreeattn_tpu_torch.training.trainer import _state_tree

    mc = MODEL_CONFIGS[MODEL]
    d, V = mc.hidden_size, mc.vocab_size // 2
    gen = torch.Generator(device=dev).manual_seed(11)
    h = torch.randn(VP_ROWS, d, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(V, d, generator=gen, device=dev) * d**-0.5).to(torch.bfloat16).t()  # the shard as held
    g_lse, g_ent = torch.randn(2, VP_ROWS, generator=gen, device=dev)
    lse, mean_x = lm_stats(h, w)
    lse_p, mean_p = lm_stats_plain(h, w)
    fwd_err = max(float((lse - lse_p).abs().max()), float((mean_x - mean_p).abs().max()))
    dh, dwT = lm_stats_bwd(h, w, lse_p, mean_p, g_lse, g_ent)
    dh_p, dwT_p = lm_stats_bwd_plain(h, w, lse_p, mean_p, g_lse, g_ent)
    bwd_rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max()) for a, b in ((dh, dh_p),
                                                                                             (dwT, dwT_p)))
    log(f"K8 / K9 on Qwen3-0.6B's vocabulary shard at tp = 2 ([{VP_ROWS}, {d}] x [{d}, {V}], {V / 256:.2f} "
        f"vocab tiles of 256, the last ragged) vs plain: lse / mean_x max|err| {fwd_err:.3e} (tol {LM_ATOL}); "
        f"dhidden / dWT max err {bwd_rel:.3e} of max|ref| (tol {LM_BWD_REL_TOL})")
    if fwd_err > LM_ATOL or bwd_rel > LM_BWD_REL_TOL:
        fail("K8 / K9 disagree with their plain versions on the tp = 2 vocabulary shard")
    del h, w, g_lse, g_ent, lse, mean_x, lse_p, mean_p, dh, dwT, dh_p, dwT_p
    gc.collect()
    torch.cuda.empty_cache()

    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        t0 = time.perf_counter()
        logs = [open(os.path.join(workdir, f"log{r}.txt"), "w") for r in range(PARALLEL_WORLD)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
                                   str(PARALLEL_WORLD), workdir], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(PARALLEL_WORLD)]
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        for p in procs:  # every process this phase started ends here
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        for r in range(PARALLEL_WORLD):  # each rank's log, but PyTorch's deprecation notices
            with open(os.path.join(workdir, f"log{r}.txt")) as f:
                for line in f.read().splitlines():
                    if "FutureWarning" not in line and "return func(" not in line:
                        log(f"[rank {r}] {line}")
        if any(p.returncode for p in procs):
            fail(f"phase 11: a rank failed or timed out (exit codes {[p.returncode for p in procs]})")
        results = []
        for r in range(PARALLEL_WORLD):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                results.append(json.load(f))
        log(f"phase 11 ranks: {time.perf_counter() - t0:.1f} s for {PARALLEL_WORLD} processes sharing one card "
            "(start, CUDA context, the checks)")
        drives = {}
        for res in results:
            for name, counts in res["drives"].items():
                base = name.rsplit(", rank ", 1)[0]
                drives[base] = {key: drives.get(base, {}).get(key, 0) + v for key, v in counts.items()}
        for r, res in enumerate(results):
            log(f"rank {r}: seconds by section: " + ", ".join(f"{name} {t:.1f}" for name, t in
                                                           res["sections_s"].items()))
            for label, t in res["ms"].items():
                extra = (f", collectives {t['collective_ms']:.1f} ms ({json.dumps(t['collectives'])})"
                         if "collectives" in t else "")
                log(f"(e) rank {r} of {PARALLEL_WORLD} ranks sharing one card (not a scaling number): {label} "
                    f"{t['step_ms']:.1f} ms{extra}")

        # (d) the checkpoint cli.train wrote at 2 x 2, restored on one device,
        # cut into each rank's shards again: bit-equal to what each rank held
        t0 = time.perf_counter()
        ck = os.path.join(workdir, "cli_ckpt")
        tr = Trainer(mc, EngineConfig(), TrainConfig(param_dtype="bf16", learning_rate=TRAINER_LR, ckpt_dir=ck),
                     device=dev)
        tr.restore()

        def digest(t):
            return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

        same = True
        for r, res in enumerate(results):
            coords = {"data": r // 2, "seq": 0, "pipe": 0, "model": r % 2}
            cut = Mesh({"data": 2, "seq": 1, "pipe": 1, "model": 2}, coords, {}, "gloo", dev, None)
            mine = {"params": [digest(t) for t in _flatten(shard_params(tr.params, cut, mc))[1]]}
            for key in ("mu", "nu"):
                mine[key] = [digest(t) for t in _flatten(shard_params(_state_tree(tr.opt_state[key], tr.params),
                                                                      cut, mc))[1]]
            same &= mine == res["hashes"]
        log(f"(d) the checkpoint cli.train wrote at dp=2 x tp=2 (step {tr.step_idx}), restored on one device and "
            f"cut into each rank's shards: params and both moments bit-equal to the ranks' own: {same}")
        if not same or tr.step_idx != 2:
            fail("phase 11 (d): the 2 x 2 checkpoint does not restore bit-equal on one device")
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        # (d) step 1 of the 2 x 2 run against --dp 1; its checkpoint resumed at --dp 1
        with open(os.path.join(workdir, "cli.jsonl")) as f:
            mesh_recs = [json.loads(line) for line in f]
        one_loss = cli_train.main(parallel_cli_argv() + ["--steps", "1"]).history[0]["loss"]
        loss_rel = abs(mesh_recs[0]["loss"] - one_loss) / abs(one_loss)
        gc.collect()
        resumed = cli_train.main(parallel_cli_argv() + ["--steps", "1", "--ckpt-dir", ck, "--resume"])
        log(f"(d) cli.train --dp 2 --tp 2 --dist-backend gloo, 2 steps in the ranks' group: losses "
            f"{[x['loss'] for x in mesh_recs]}; step 1 {mesh_recs[0]['loss']:.6f} vs --dp 1 {one_loss:.6f} "
            f"(rel {loss_rel:.3e}, tol {STEP_LOSS_RTOL}); its checkpoint resumed at --dp 1: step "
            f"{resumed.step_idx}, loss {resumed.history[-1]['loss']:.6f}; {time.perf_counter() - t0:.1f} s in "
            "the parent")
        if (len(mesh_recs) != 2 or loss_rel > STEP_LOSS_RTOL or resumed.step_idx != 3
                or not math.isfinite(resumed.history[-1]["loss"])):
            fail("phase 11 (d): cli.train on the mesh disagrees with --dp 1 or does not resume")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return drives, one_loss, [x["loss"] for x in mesh_recs]


# Phase 12: ZeRO-3 (FSDP) and sequence parallelism, Ulysses and ring, over
# torch.distributed, Qwen3-0.6B at full width and depth on the bench trie:
# SP_WORLD ranks, fresh processes of this script (--sp-rank) sharing the one
# card over gloo with CUDA tensors, as in phase 11. Correctness only: no time
# of ranks that share one card is a scaling number.
SP_WORLD = 4
SP_TIMEOUT_S = 600
# the ring layout whose (q shard, kv shard) pairs the parent holds K2, K11
# and K12 with offsets against their plain versions at
RING_CHECK_SP = 4
# (e) the ZeRO-3 layout must hold at most this share of the replicated
# layout's params + AdamW moments a rank (dp = 2: the large leaves halve;
# the norms, ~0.02% of them, stay whole)
ZERO3_MEMORY_SHARE = 0.6
# (f), (g): the sequence-parallel step against the one-device step on the
# same trie: the issue's loss bar (the grads at phase 4's)
SP_LOSS_RTOL = 1e-4


def ring_pair_checks(dev, flush, seqs, attachs) -> dict:
    """K2, K11 and K12 with position offsets against their plain versions at
    every live (q shard, kv shard) pair of the RING_CHECK_SP ring layout of
    the bench trie, Qwen3-0.6B's head layout (8 kv heads, group 2, head_dim
    128), random bf16 q, k, v, do; K11 / K12 from the whole sequence's lse
    and di, as the ring's backward takes them. A row that sees no key of a
    pair must be one in both (lse below -1e30: it merges with weight 0);
    the rest within the attention bars. Each live pair's ms; the empty pairs
    counted. Returns {"pairs": [...], "empty": E, "max_abs_err": {...}}."""
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.ops.tree_attention_ring import RING_META_FIELDS, ring_pairs
    import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module, not the function)
    from dynamictreeattn_tpu_torch.tries import TokenTrie, build_block_meta, build_ring_block_meta, flatten_trie
    from dynamictreeattn_tpu_torch.tries.flatten import _pad_packed

    ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
    mc = MODEL_CONFIGS[MODEL]
    sp, bq = RING_CHECK_SP, 128
    packed = flatten_trie(TokenTrie(seqs, attachs))
    n = -(-packed.n_padded // (sp * bq)) * sp * bq
    packed = _pad_packed(packed, n)
    ld_np, n_loc = packed.last_desc, n // sp
    ld = torch.from_numpy(ld_np).to(dev)
    hkv, g, dh = mc.num_key_value_heads, mc.num_attention_heads // mc.num_key_value_heads, mc.head_dim
    gen = torch.Generator(device=dev).manual_seed(12)
    q4, do = (torch.randn(hkv, g, n, dh, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(hkv, n, dh, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    scale = dh**-0.5
    meta = build_block_meta(ld_np, bq, bq)
    tm = [torch.from_numpy(getattr(meta, f)).to(dev) for f in RING_META_FIELDS[:3]]
    qw = ta.qmajor_work(ld_np, meta.kv_ids, meta.kv_counts, meta.kv_types, bq, bq, dev)
    o, lse = ta.tree_attn_fwd_online(q4, k, v, ld, *tm, scale, bq, bq, work=qw)
    di = torch.sum(do.float() * o.float(), dim=-1)
    rm = build_ring_block_meta(ld_np, sp, bq, bq)
    rmeta = {f: getattr(rm, f) for f in RING_META_FIELDS}
    out = {"n": n, "sp": sp, "pairs": [], "empty": 0, "max_abs_err": {"K2 o": 0.0, "K2 lse": 0.0, "K11 dq": 0.0,
                                                                       "K12 dk": 0.0, "K12 dv": 0.0}}
    for me in range(sp):
        rows = slice(me * n_loc, (me + 1) * n_loc)
        qm, dom = q4[:, :, rows].contiguous(), do[:, :, rows].contiguous()
        tail = (dom, lse[:, :, rows].contiguous(), di[:, :, rows].contiguous(), scale, bq, bq)
        for pair in ring_pairs(ld_np, rmeta, me, sp, bq, bq, dev, hkv, dh, work=True):
            if not pair.live:
                out["empty"] += 1
                continue
            keys = slice(pair.kv_off, pair.kv_off + n_loc)
            km, vm = k[:, keys].contiguous(), v[:, keys].contiguous()
            offs = dict(q_off=pair.q_off, kv_off=pair.kv_off)
            label = f"ring pair (q shard {me}, kv shard {pair.src}) at offsets ({pair.q_off}, {pair.kv_off})"
            o_k, l_k = ta.tree_attn_fwd_online(qm, km, vm, ld, *pair.meta[:3], scale, bq, bq, work=pair.qwork,
                                               **offs)
            o_p, l_p = ta.tree_attn_fwd_plain(qm, km, vm, ld, *pair.meta[:3], scale, bq, bq, **offs)
            no_key = l_p < -1e30
            if not torch.equal(no_key, l_k < -1e30):
                fail(f"K2 {label}: {int((no_key != (l_k < -1e30)).sum())} rows see no key in one version only")
            seen = ~no_key
            errs = {"K2 o": check_close(f"K2 {label} o", o_k[seen], o_p[seen], ATTN_O_ATOL, ATTN_O_RTOL),
                    "K2 lse": check_close(f"K2 {label} lse", l_k[seen], l_p[seen], ATTN_LSE_ATOL)}
            dq_k = ta.tree_attn_bwd_dq(qm, km, vm, ld, *pair.meta[:3], *tail, work=pair.qwork, **offs)
            dq_p = ta.tree_attn_bwd_dq_plain(qm, km, vm, ld, *pair.meta[:3], *tail, **offs)
            dk_k, dv_k = ta.tree_attn_bwd_dkv(qm, km, vm, ld, *pair.meta[3:], *tail, work=pair.kwork, **offs)
            dk_p, dv_p = ta.tree_attn_bwd_dkv_plain(qm, km, vm, ld, *pair.meta[3:], *tail, **offs)
            errs["K11 dq"] = check_rel(f"K11 {label} dq", dq_k, dq_p, BWD_REL_TOL)
            errs["K12 dk"] = check_rel(f"K12 {label} dk", dk_k, dk_p, BWD_REL_TOL)
            errs["K12 dv"] = check_rel(f"K12 {label} dv", dv_k, dv_p, BWD_REL_TOL)
            for key, e in errs.items():
                out["max_abs_err"][key] = max(out["max_abs_err"][key], e)
            ms = {
                "K2": cuda_ms(lambda: ta.tree_attn_fwd_online(qm, km, vm, ld, *pair.meta[:3], scale, bq, bq,
                                                              work=pair.qwork, **offs), 5, flush),
                "K11": cuda_ms(lambda: ta.tree_attn_bwd_dq(qm, km, vm, ld, *pair.meta[:3], *tail, work=pair.qwork,
                                                           **offs), 5, flush),
                "K12": cuda_ms(lambda: ta.tree_attn_bwd_dkv(qm, km, vm, ld, *pair.meta[3:], *tail, work=pair.kwork,
                                                            **offs), 5, flush)}
            entries = int(pair.qwork.tiles[:, 2].sum())
            out["pairs"].append({"me": me, "src": pair.src, "entries": entries, "units": len(pair.kwork.units),
                                 "rows_seeing_no_key": int(no_key.sum()), "rows": no_key.numel(), "ms": ms})
            log(f"{label}: {entries} live 64 x 64 sub-tiles; rows that see no key {int(no_key.sum())} of "
                f"{no_key.numel()} (lse below -1e30 in both); K2 o / lse max|err| {errs['K2 o']:.3e} / "
                f"{errs['K2 lse']:.3e}, K11 dq {errs['K11 dq']:.3e}, K12 dk / dv {errs['K12 dk']:.3e} / "
                f"{errs['K12 dv']:.3e}; ms K2 {ms['K2']:.4f}, K11 {ms['K11']:.4f}, K12 {ms['K12']:.4f}")
    log(f"ring layout sp={sp} of the bench trie (n {n}, shards of {n_loc}): {len(out['pairs'])} live pairs, "
        f"{out['empty']} empty (a later shard's keys: nothing launched); max|err| over the pairs "
        + json.dumps({k_: float(f"{e:.4e}") for k_, e in out["max_abs_err"].items()}))
    return out


def _cut_over_data(tree: dict, mesh, mc) -> dict:
    """This rank's ZeRO-3 slices of a tree in the replicated layout (each
    leaf cut on its fsdp dim by data rank), on the device: what a ZeRO-3
    step's grads must equal."""
    from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten, _unflatten
    from dynamictreeattn_tpu_torch.parallel import fsdp_dims

    dp, r = mesh.size("data"), mesh.rank("data")
    dims = fsdp_dims(mc, dp)
    flat = {**{k: v for k, v in dims.items() if k != "layers"}, **dims["layers"]}
    names, leaves = _flatten(tree)
    out = []
    for path, t in zip(names, leaves):
        d = flat[path[-1]]
        out.append(t if d < 0 else t.narrow(d, r * (t.shape[d] // dp), t.shape[d] // dp))
    return _unflatten(tree, names, out)


def sp_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 12 (``--sp-rank RANK WORLD DIR``): (e) ZeRO-3 at dp =
    2 and dp = 2 x tp = 2, (f) Ulysses at sp = 2 x tp = 2 and sp = 4, (g) the
    ring at sp = 4 and sp = 2 x tp = 2, (h) ``cli.train --dp 2 --sp 2
    --fsdp``; writes its results to DIR/sp_rank<RANK>.json."""
    import collections
    import datetime
    import gc

    t_entry = time.perf_counter()

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamictreeattn_tpu_torch.cli import train as cli_train
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
    from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.parallel import make_mesh, make_train_step, shard_params, stack_batches
    from dynamictreeattn_tpu_torch.parallel import collectives as coll
    from dynamictreeattn_tpu_torch.training import OptaxAdamW, TrainConfig, Trainer
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=SP_TIMEOUT_S))
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"drives": {}, "ms": {}, "sections_s": {}, "memory": {}}
    t_section = t_entry

    def section_done(name: str):
        nonlocal t_section
        now = time.perf_counter()
        out["sections_s"][name] = now - t_section
        t_section = now

    coll_stats = collections.defaultdict(lambda: [0, 0.0])
    real_call = coll._call

    def timed_call(name, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_call(name, *args, **kwargs)
        coll_stats[name][0] += 1
        coll_stats[name][1] += (time.perf_counter() - t0) * 1e3

    coll._call = timed_call

    def measured(label: str, run, group):
        """run() with launch counts from 0 and the collectives' tally, the
        ranks of `group` starting together: (result, counts)."""
        torch.cuda.synchronize()
        dist.barrier(group=group)
        _build.reset_launches()
        coll_stats.clear()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        counts = _build.launches()
        out["ms"][label] = {"step_ms": (time.perf_counter() - t0) * 1e3,
                            "collective_ms": sum(v[1] for v in coll_stats.values()),
                            "collectives": {k: v[0] for k, v in coll_stats.items()}}
        return res, counts

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def need(label: str, counts: dict, kernels, absent=()):
        """The drive launched each of `kernels` and none of `absent`."""
        out["drives"][f"{label}, rank {rank}"] = counts
        missing = [KERNEL_IDS[k] for k in kernels if not counts.get(k)]
        extra = [KERNEL_IDS[k] for k in absent if counts.get(k)]
        if missing or extra:
            fail(f"{label} rank {rank}: launched {by_id(counts)}; missing {missing}, unexpected {extra}")

    def same(a: dict, b: dict) -> bool:
        return all(torch.equal(x, y) for x, y in zip(_flatten(a)[1], _flatten(b)[1]))

    section_done("start (imports, process group)")
    mc = MODEL_CONFIGS[MODEL]
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
                                            completion_len=(128, 512), branch_prob=0.85)
    params = init_params(mc, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)

    # ---- (e) ZeRO-3 at dp = 2 (ranks 0, 1) and dp = 2 x tp = 2 (all four)
    for dp, tp in ((2, 1), (2, 2)):
        mesh = make_mesh(dp=dp, tp=tp, backend="gloo", device=DEVICE)
        if mesh is None:
            continue
        label = "dp=2" if tp == 1 else "dp=2 x tp=2"
        tries = _bin_tries(seqs, attachs, dp)
        ec = EngineConfig(bwd_mode="split")
        layouts = {}
        for name, fsdp in (("replicated", False), ("ZeRO-3", True)):
            free()
            m0 = torch.cuda.memory_allocated()
            local = shard_params(params, mesh, mc, fsdp=fsdp)
            state = OptaxAdamW(TRAINER_LR).init(local)
            out["memory"][f"{label} {name}"] = torch.cuda.memory_allocated() - m0
            step = make_train_step(mc, ec, mesh=mesh, fsdp=fsdp)
            batch = stack_batches(tries, ec, engine=step.engine, mesh=mesh)
            layouts[name] = measured(f"(e) {label} {name} step, split", lambda: step(local, batch),
                                     mesh.everyone)
            del state
            if fsdp and tp == 1:  # "auto" (K3's dq sums in no fixed order) within phase 4's bars
                auto = make_train_step(mc, EngineConfig(), mesh=mesh, fsdp=True)
                abatch = stack_batches(tries, EngineConfig(), engine=auto.engine, mesh=mesh)
                (la, ga, _), c_auto = measured(f"(e) {label} ZeRO-3 step, auto", lambda: auto(local, abatch),
                                               mesh.everyone)
                need("parallel (e) ZeRO-3 dp=2 step auto", c_auto, TRAIN_KERNELS)
                ref_cut = _cut_over_data(layouts["replicated"][0][1], mesh, mc)
                check_step(f"(e) rank {rank}: ZeRO-3 dp=2 step (\"auto\") vs the replicated \"split\" step",
                           (la, ga, None), (layouts["replicated"][0][0], ref_cut, None))
                del auto, abatch, ga, ref_cut
            del step, batch, local
        (l0, g0, _), c0 = layouts["replicated"]
        (l1, g1, _), c1 = layouts["ZeRO-3"]
        bit = torch.equal(l0, l1) and same(_cut_over_data(g0, mesh, mc), g1)
        mem = {k_: out["memory"][f"{label} {k_}"] for k_ in ("replicated", "ZeRO-3")}
        log(f"(e) rank {rank}, {label}, bwd_mode=\"split\": ZeRO-3 step loss {float(l1):.6f}, replicated "
            f"{float(l0):.6f}; loss and all {len(_flatten(g1)[1])} grads (this rank's ZeRO-3 slices) bit-equal: "
            f"{bit}; launches {by_id(c1)} (replicated {by_id(c0)}); memory_allocated after shard_params + AdamW "
            f"init: ZeRO-3 {mem['ZeRO-3'] / 2**30:.3f} GiB, replicated {mem['replicated'] / 2**30:.3f} GiB "
            f"({mem['ZeRO-3'] / mem['replicated']:.3f} of it; a rank's own allocations, not a scaling number)")
        if not bit or c0 != c1:
            fail(f"(e) rank {rank} {label}: the ZeRO-3 step is not bit-equal to the replicated one, or launched "
                 "other kernels")
        if mem["ZeRO-3"] > ZERO3_MEMORY_SHARE * mem["replicated"]:
            fail(f"(e) rank {rank} {label}: the ZeRO-3 shards hold {mem['ZeRO-3']} bytes, the replicated layout "
                 f"{mem['replicated']}")
        need(f"parallel (e) ZeRO-3 {label} step split", c1, ("tree_attn_bwd_dq", "tree_attn_bwd_dkv",
                                                                "lm_stats_fwd", "lm_stats_bwd", "qk_prep_fwd_q"))
        del layouts, g0, g1
        free()
        if tp == 1:
            # one optimizer step with no clip through the Trainer in each
            # layout, each saving its gathered checkpoint for the parent to
            # compare bit for bit
            for name, fsdp in (("replicated", False), ("zero3", True)):
                tc = TrainConfig(dp=2, param_dtype="bf16", learning_rate=TRAINER_LR, grad_clip=0.0,
                                 lb_method="LB_by_n_tokens", fsdp=fsdp,
                                 ckpt_dir=os.path.join(workdir, f"trainer_{name}"))
                tr = Trainer(mc, EngineConfig(bwd_mode="split"), tc, mesh=mesh)
                tr.set_params(params)
                rec, c_tr = measured(f"(e) Trainer {name} step", lambda: tr.train_step(seqs, attachs),
                                     mesh.everyone)
                tr.save()
                log(f"(e) rank {rank}: Trainer dp=2 {name}, one step without clip: loss {rec['loss']:.6f}; "
                    "saved its gathered checkpoint")
                if fsdp:
                    need("parallel (e) ZeRO-3 Trainer step", c_tr, ("tree_attn_bwd_dq", "tree_attn_bwd_dkv"))
                del tr
                free()
        section_done(f"(e) {label}")

    # ---- (f), (g): Ulysses and the ring against the one-device step on the
    # same trie, run on this rank (no collective of its own)
    ec = EngineConfig()
    trie = TokenTrie(seqs, attachs)
    eng = TreeEngine(mc, ec, device=dev)
    (ref_loss, ref, _), _ = measured("(f) one-device step", lambda: eng.loss_and_grad(params, eng.prepare(trie)),
                                     dist.group.WORLD)
    del eng
    free()
    section_done("(f) one-device reference")
    modes = {"ulysses": ("tree_attn_fwd_bound", "tree_attn_bwd_fused", "lm_stats_fwd", "lm_stats_bwd"),
             "ring": ("tree_attn_fwd_online", "tree_attn_bwd_dq", "tree_attn_bwd_dkv", "qk_prep_fwd_q",
                      "qk_prep_fwd_kv", "qk_prep_bwd_q", "qk_prep_bwd_kv", "lm_stats_fwd", "lm_stats_bwd")}
    absent = {"ulysses": ("tree_attn_bwd_cached", "qk_prep_fwd_q", "qk_prep_bwd_q"),
              "ring": ("tree_attn_fwd_bound", "tree_attn_bwd_cached", "tree_attn_bwd_fused")}
    for mode, sp, tp in (("ulysses", 2, 2), ("ulysses", 4, 1), ("ring", 4, 1), ("ring", 2, 2)):
        mesh = make_mesh(dp=1, tp=tp, sp=sp, backend="gloo", device=DEVICE)
        label = f"{mode} sp={sp}" + (f" x tp={tp}" if tp > 1 else "")
        step = make_train_step(mc, ec, mesh=mesh, sp_mode=mode)
        batch = stack_batches([trie], ec, sp=sp, sp_mode=mode, engine=step.engine, mesh=mesh)
        local = shard_params(params, mesh, mc)
        (loss, grads, _), counts = measured(f"({'f' if mode == 'ulysses' else 'g'}) {label} step",
                                            lambda: step(local, batch), mesh.everyone)
        extra = ""
        if mode == "ring":
            live = [p.src for p in batch.seq.ring if p.live]
            extra = f"; ring steps live {len(live)} of {sp} (kv shards {live})"
        log(f"({'f' if mode == 'ulysses' else 'g'}) rank {rank}, {label}: rows {batch.seq.rows.start} .. "
            f"{batch.seq.rows.stop} of {batch.packeds[0].n_padded}; launches {by_id(counts)}{extra}")
        check_step(f"({'f' if mode == 'ulysses' else 'g'}) rank {rank}: {label} step vs the one-device step "
                   "(its shards)", (loss, grads, None), (ref_loss, shard_params(ref, mesh, mc), None))
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        if loss_rel > SP_LOSS_RTOL:
            fail(f"{label}: loss rel {loss_rel:.3e} > {SP_LOSS_RTOL}")
        need(f"parallel ({'f' if mode == 'ulysses' else 'g'}) {label} step", counts, modes[mode], absent[mode])
        del step, batch, local, grads
        free()
        section_done(f"({'f' if mode == 'ulysses' else 'g'}) {label}")
    del ref, params
    free()

    # ---- (h) cli.train --dp 2 --sp 2 --fsdp in this process group (as under torchrun)
    ckpt, stats_out = os.path.join(workdir, "sp_cli_ckpt"), os.path.join(workdir, "sp_cli.jsonl")
    tr, c_cli = measured("(h) cli.train --dp 2 --sp 2 --fsdp: 2 steps and the save", lambda: cli_train.main(
        parallel_cli_argv() + ["--steps", "2", "--dp", "2", "--sp", "2", "--fsdp", "--dist-backend", "gloo",
                               "--ckpt-dir", ckpt, "--stats-out", stats_out]), dist.group.WORLD)
    need("parallel (h) cli.train dp=2 x sp=2 ZeRO-3, 2 steps", c_cli, ("tree_attn_fwd_bound", "tree_attn_bwd_fused"))
    log(f"(h) rank {rank}: cli.train --dp 2 --sp 2 --fsdp losses {[x['loss'] for x in tr.history]}, saved a "
        f"gathered checkpoint of step {tr.step_idx}")
    if not all(math.isfinite(x["loss"]) for x in tr.history):
        fail("(h) cli.train's loss at dp=2 x sp=2 is not finite")
    del tr
    free()
    section_done("(h) cli.train dp=2 x sp=2 ZeRO-3")
    out["sections_s"]["whole rank"] = time.perf_counter() - t_entry
    with open(os.path.join(workdir, f"sp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    coll._call = real_call
    dist.barrier()
    dist.destroy_process_group()


def sp_phase(dev, flush, seqs, attachs, one_loss: float) -> tuple[dict, dict]:
    """Phase 12 in the parent: K2 / K11 / K12 with offsets at the ring
    layout's pairs (``ring_pair_checks``); the ranks (``sp_rank``,
    SP_WORLD fresh processes on the one card, their logs printed here); the
    two Trainers' gathered checkpoints (ZeRO-3 and replicated) bit-equal;
    the ranks' cli.train --dp 2 --sp 2 --fsdp step 1 against --dp 1's
    (`one_loss`, phase 11's) and its checkpoint resumed at --dp 1. Returns
    (the ranks' drives {name: launches} summed over the ranks, the ring
    pairs' checks)."""
    import gc
    import shutil
    import tempfile

    from dynamictreeattn_tpu_torch.cli import train as cli_train
    from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten
    from dynamictreeattn_tpu_torch.training import CheckpointManager

    ring = ring_pair_checks(dev, flush, seqs, attachs)
    gc.collect()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        t0 = time.perf_counter()
        logs = [open(os.path.join(workdir, f"log{r}.txt"), "w") for r in range(SP_WORLD)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sp-rank", str(r), str(SP_WORLD),
                                   workdir], stdout=logs[r], stderr=subprocess.STDOUT) for r in range(SP_WORLD)]
        deadline = time.monotonic() + SP_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        for p in procs:  # every process this phase started ends here
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        for r in range(SP_WORLD):
            with open(os.path.join(workdir, f"log{r}.txt")) as f:
                for line in f.read().splitlines():
                    if "FutureWarning" not in line and "return func(" not in line:
                        log(f"[rank {r}] {line}")
        if any(p.returncode for p in procs):
            fail(f"phase 12: a rank failed or timed out (exit codes {[p.returncode for p in procs]})")
        results = []
        for r in range(SP_WORLD):
            with open(os.path.join(workdir, f"sp_rank{r}.json")) as f:
                results.append(json.load(f))
        log(f"phase 12 ranks: {time.perf_counter() - t0:.1f} s for {SP_WORLD} processes sharing one card")
        drives = {}
        for res in results:
            for name, counts in res["drives"].items():
                base = name.rsplit(", rank ", 1)[0]
                drives[base] = {key: drives.get(base, {}).get(key, 0) + v for key, v in counts.items()}
        for r, res in enumerate(results):
            log(f"rank {r}: seconds by section: " + ", ".join(f"{name} {t:.1f}" for name, t in
                                                           res["sections_s"].items()))
            for label, t in res["ms"].items():
                log(f"rank {r} of {SP_WORLD} ranks sharing one card (not a scaling number): {label} "
                    f"{t['step_ms']:.1f} ms, collectives {t['collective_ms']:.1f} ms ({json.dumps(t['collectives'])})")

        # (e) the two Trainers' checkpoints, each gathered to one file
        t0 = time.perf_counter()
        saved = {name: CheckpointManager(os.path.join(workdir, f"trainer_{name}")).restore(map_location="cpu")
                 for name in ("replicated", "zero3")}
        a, b = saved["replicated"], saved["zero3"]
        leaves = lambda ck: _flatten(ck["params"])[1] + [t for key in ("mu", "nu") for t in ck["opt_state"][key]]
        bit = all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b))) and len(leaves(a)) == len(leaves(b))
        log(f"(e) one AdamW step without clip at dp=2, ZeRO-3 and replicated Trainers: their gathered checkpoints' "
            f"params and both moments ({len(leaves(a))} tensors) bit-equal: {bit}")
        if not bit:
            fail("phase 12 (e): the ZeRO-3 Trainer's step or checkpoint differs from the replicated one's")
        del saved, a, b

        # (h) step 1 against --dp 1; the checkpoint resumed at --dp 1
        with open(os.path.join(workdir, "sp_cli.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss_rel = abs(recs[0]["loss"] - one_loss) / abs(one_loss)
        resumed = cli_train.main(parallel_cli_argv() + ["--steps", "1", "--ckpt-dir",
                                                        os.path.join(workdir, "sp_cli_ckpt"), "--resume"])
        log(f"(h) cli.train --dp 2 --sp 2 --fsdp --dist-backend gloo, 2 steps in the ranks' group: losses "
            f"{[x['loss'] for x in recs]}; step 1 {recs[0]['loss']:.6f} vs --dp 1 {one_loss:.6f} (rel "
            f"{loss_rel:.3e}, tol {SP_LOSS_RTOL}); its checkpoint resumed at --dp 1: step {resumed.step_idx}, loss "
            f"{resumed.history[-1]['loss']:.6f}; {time.perf_counter() - t0:.1f} s in the parent")
        if (len(recs) != 2 or loss_rel > SP_LOSS_RTOL or resumed.step_idx != 3
                or not math.isfinite(resumed.history[-1]["loss"])):
            fail("phase 12 (h): cli.train --dp 2 --sp 2 --fsdp disagrees with --dp 1 or does not resume")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return drives, ring


# Phase 13: pipeline parallelism (GPipe and 1F1B) and the multi-host
# bring-up over torch.distributed, Qwen3-0.6B at full width and depth:
# PP_WORLD ranks, fresh processes of this script (--pp-rank) sharing the one
# card over gloo with CUDA tensors, laid out as PP_HOSTS "hosts" with the
# environment of a multi-node torchrun launch. Correctness only: no time or
# memory of ranks that share one card is a scaling number.
PP_WORLD, PP_HOSTS = 4, 2
PP_TIMEOUT_S = 600
# microbatches a data rank, and the schedules' drives: (schedule, dp, pp, tp)
PP_M = 4
PP_DRIVES = (("gpipe", 1, 2, 1), ("1f1b", 1, 2, 1), ("gpipe", 1, 4, 1), ("1f1b", 1, 4, 1), ("gpipe", 1, 2, 2),
             ("1f1b", 1, 2, 2), ("gpipe", 2, 2, 1))
# (c): 1F1B's activation peak (a process's max_memory_allocated during the
# step, less what it held before and the fp32 grad accumulators) at 2 PP_M
# microbatches within this factor of its peak at PP_M
PP_FLAT = 1.1
PP_KERNELS = ("tree_attn_fwd_bound", "tree_attn_fwd_online", "tree_attn_bwd_fused", "lm_stats_fwd", "lm_stats_bwd")
PP_ABSENT = ("tree_attn_bwd_cached", "tree_attn_bwd_dq", "tree_attn_bwd_dkv", "qk_prep_fwd_q", "qk_prep_fwd_kv",
             "qk_prep_bwd_q", "qk_prep_bwd_kv")


def pp_counts(schedule: str, stage: int, pp: int, L: int, M: int) -> dict:
    """The launches one stage of the pipelined step makes: each microbatch
    runs the stage's L/pp layers under remat (the forward, then its
    recompute in the backward: K1/K2 twice, K10 once a layer); 1F1B runs
    one more forward without a graph to send on, except on the last stage,
    whose forward and backward fall on one microbatch in one tick; the last
    stage runs K8 and K9 once a microbatch. Bubble ticks launch nothing."""
    lpp, last = L // pp, stage == pp - 1
    counts = {name: 0 for name in PP_ABSENT}
    counts.update(fwd=M * lpp * (2 if schedule == "gpipe" or last else 3), tree_attn_bwd_fused=M * lpp,
                  lm_stats_fwd=M if last else 0, lm_stats_bwd=M if last else 0)
    return counts


def pp_rank(rank: int, world: int, workdir: str, port: int, port2: int) -> None:
    """One rank of phase 13 (``--pp-rank RANK WORLD DIR PORT PORT2``): the
    process group from ``initialize_multihost`` on the two-host environment
    (``MASTER_PORT`` PORT); (a), (b) the drives of PP_DRIVES against the
    parent's references, with their launches; (c) the memory drives; (d)
    ``cli.train --pp 2 --pp-schedule 1f1b``; (e) the host checks, then the
    group destroyed and ``cli.train --dp 2 --tp 2 --multihost`` starting a
    fresh one on PORT2; writes its results to DIR/pp_rank<RANK>.json."""
    import collections
    import gc

    t_entry = time.perf_counter()
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    per_host = world // PP_HOSTS
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % per_host),
                      LOCAL_WORLD_SIZE=str(per_host), GROUP_RANK=str(rank // per_host), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from dynamictreeattn_tpu_torch.cli import train as cli_train
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.parallel import make_mesh, make_pp_train_step, shard_params, stack_microbatches
    from dynamictreeattn_tpu_torch.parallel import collectives as coll
    from dynamictreeattn_tpu_torch.parallel.distributed import HostInfo, initialize_multihost, local_data_ranks
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    torch.set_num_threads(2)
    info = initialize_multihost(backend="gloo", device=DEVICE)  # env:// of the launcher's environment
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"drives": {}, "ms": {}, "sections_s": {}, "memory": {}, "checks": []}
    t_section = t_entry

    def section_done(name: str):
        nonlocal t_section
        now = time.perf_counter()
        out["sections_s"][name] = now - t_section
        t_section = now

    coll_stats = collections.defaultdict(lambda: [0, 0.0])
    real_call = coll._call

    def timed_call(name, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_call(name, *args, **kwargs)
        coll_stats[name][0] += 1
        coll_stats[name][1] += (time.perf_counter() - t0) * 1e3

    coll._call = timed_call

    def measured(label: str, run, group):
        """run() with launch counts from 0, the collectives' tally and the
        process's peak memory above what it held before, the ranks of
        `group` starting together: (result, counts, peak bytes)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        dist.barrier(group=group)
        _build.reset_launches()
        coll_stats.clear()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        counts = _build.launches()
        peak = torch.cuda.max_memory_allocated() - base
        out["ms"][label] = {"step_ms": (time.perf_counter() - t0) * 1e3,
                            "collective_ms": sum(v[1] for v in coll_stats.values()),
                            "collectives": {k: v[0] for k, v in coll_stats.items()}}
        return res, counts, peak

    want_info = HostInfo(rank, world, torch.cuda.device_count(), PP_HOSTS * torch.cuda.device_count())
    again = initialize_multihost(backend="gloo", device=DEVICE)
    out["checks"].append(("(e) HostInfo", info == want_info and again == info))
    log(f"(e) rank {rank}: initialize_multihost -> {info}, again {again} (want {want_info})")
    section_done("start (imports, initialize_multihost)")

    mc = MODEL_CONFIGS[MODEL]
    L = mc.num_hidden_layers
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
                                            completion_len=(128, 512), branch_prob=0.85)
    with open(os.path.join(workdir, "bins.json")) as f:
        bins = json.load(f)
    tries = {m: [TokenTrie([seqs[i] for i in ids], [attachs[i] for i in ids]) for ids in b] for m, b in bins.items()}
    params = init_params(mc, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    refs = {m: torch.load(os.path.join(workdir, f"ref{m}.pt"), map_location="cpu", mmap=True) for m in bins}
    ec = EngineConfig()
    section_done("setup (params, tries, references)")

    def drive(schedule, dp, pp, tp, rows, label, ref, scale=1):
        """One pipelined step on every rank of its mesh: checks (a) against
        `scale` x `ref` (loss, grads) and (b) the exact launches; returns
        the activation peak (None off the mesh)."""
        mesh = make_mesh(dp=dp, tp=tp, pp=pp, backend="gloo", device=DEVICE)
        if mesh is None:
            return None
        stage, M = mesh.rank("pipe"), len(rows[0])
        step = make_pp_train_step(mc, mesh, ec, schedule=schedule)
        batch = stack_microbatches(rows, ec, engine=step.engine, mesh=mesh)
        local = shard_params(params, mesh, mc)
        acc_bytes = sum(t.numel() * 4 for t in _flatten(local)[1])
        (loss, grads, _), counts, peak = measured(label, lambda: step(local, batch), mesh.everyone)
        act = peak - acc_bytes
        cut = shard_params(ref["grads"], mesh, mc)
        ref_loss = scale * ref["loss"]
        loss_rel = abs(float(loss) - ref_loss) / abs(ref_loss)
        rels = sorted(((float(torch.linalg.vector_norm(g.double() - scale * r.double())
                             / torch.linalg.vector_norm(scale * r.double()).clamp(min=1e-30)), "/".join(path))
                       for path, g, r in zip(_flatten(grads)[0], _flatten(grads)[1], _flatten(cut)[1])), reverse=True)
        embed = next(rel for rel, name in rels if name == "embed")
        want = pp_counts(schedule, stage, pp, L, M)
        got = {"fwd": counts["tree_attn_fwd_bound"] + counts["tree_attn_fwd_online"],
               **{k: counts.get(k, 0) for k in want if k != "fwd"}}
        n = batch.packeds[0].n_padded
        log(f"(a) rank {rank} (data {mesh.rank('data')}, stage {stage}, model {mesh.rank('model')}), {label}: "
            f"{M} microbatches of n {n}, layers {stage * L // pp}..{(stage + 1) * L // pp - 1}; loss "
            f"{float(loss):.6f} vs the one-device steps summed {ref_loss:.6f} (rel {loss_rel:.3e}, tol "
            f"{SP_LOSS_RTOL}); {len(rels)} grads of this rank's slices, worst {rels[0][1]} {rels[0][0]:.4e} (tol "
            f"{STEP_GRAD_REL}), the tied embedding {embed:.4e}; (b) launches {by_id(counts)}, K1+K2 {got['fwd']} "
            f"(schedule's {want['fwd']}), K10 {got['tree_attn_bwd_fused']} ({want['tree_attn_bwd_fused']}), K8 / K9 "
            f"{got['lm_stats_fwd']} / {got['lm_stats_bwd']} ({want['lm_stats_fwd']}); activation peak "
            f"{act / 2**30:.3f} GiB (a process's own allocations)")
        out["drives"][f"pipeline {label}, rank {rank}"] = counts
        out["checks"].append((f"(a) {label} rank {rank}", loss_rel <= SP_LOSS_RTOL and rels[0][0] <= STEP_GRAD_REL
                              and all(math.isfinite(r) for r, _ in rels)))
        out["checks"].append((f"(b) {label} rank {rank} launches", got == want))
        return act

    t4 = tries[str(PP_M)]
    acts = {}
    for schedule, dp, pp, tp in PP_DRIVES:
        m = str(dp * PP_M)
        rows = [tries[m][r * PP_M:(r + 1) * PP_M] for r in range(dp)]
        label = f"{schedule} " + " x ".join(f"{a}={v}" for a, v in (("dp", dp), ("pp", pp), ("tp", tp))
                                            if v > 1 or a == "pp") + f", M={PP_M}"
        act = drive(schedule, dp, pp, tp, rows, label, refs[m])
        if (dp, pp, tp) == (1, 2, 1) and act is not None:
            acts[schedule, PP_M] = act
        section_done(f"(a) {label}")
    # ---- (c) the same microbatches twice: 2 PP_M of one size, twice the reference
    for schedule in ("gpipe", "1f1b"):
        act = drive(schedule, 1, 2, 1, [t4 + t4], f"{schedule} pp=2, M={2 * PP_M} (the M={PP_M} tries twice)",
                    refs[str(PP_M)], scale=2)
        if act is not None:
            acts[schedule, 2 * PP_M] = act
        section_done(f"(c) {schedule} M={2 * PP_M}")
    if acts:
        out["memory"] = {f"{s} M={m}": v for (s, m), v in acts.items()}
        flat = acts["1f1b", 2 * PP_M] <= PP_FLAT * acts["1f1b", PP_M]
        grows = acts["gpipe", 2 * PP_M] > acts["gpipe", PP_M]
        log(f"(c) rank {rank}, pp=2: activation peak (max_memory_allocated during the step, less what the process "
            "held before and the fp32 grad accumulators; a process's own allocations, no scaling claim): "
            + ", ".join(f"{s} M={m} {v / 2**30:.3f} GiB" for (s, m), v in sorted(acts.items()))
            + f"; 1F1B {acts['1f1b', 2 * PP_M] / acts['1f1b', PP_M]:.3f}x (limit {PP_FLAT}), GPipe "
            f"{acts['gpipe', 2 * PP_M] / acts['gpipe', PP_M]:.3f}x")
        out["checks"].append((f"(c) rank {rank}: 1F1B flat, GPipe grows", flat and grows))
    del params, refs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) cli.train --pp 2 --pp-schedule 1f1b in this process group (as under torchrun)
    ckpt, stats_out = os.path.join(workdir, "pp_cli_ckpt"), os.path.join(workdir, "pp_cli.jsonl")
    tr, c_cli, _ = measured("(d) cli.train --pp 2 --pp-schedule 1f1b --microbatches 4: 2 steps and the save",
                            lambda: cli_train.main(parallel_cli_argv() + [
                                "--steps", "2", "--pp", "2", "--pp-schedule", "1f1b", "--microbatches", "4",
                                "--dist-backend", "gloo", "--ckpt-dir", ckpt, "--stats-out", stats_out]),
                            dist.group.WORLD)
    if tr is not None:
        out["drives"][f"pipeline (d) cli.train pp=2 1f1b, 2 steps, rank {rank}"] = c_cli
        log(f"(d) rank {rank}: cli.train --pp 2 --pp-schedule 1f1b losses {[x['loss'] for x in tr.history]}; "
            f"launches {by_id(c_cli)}")
        out["checks"].append((f"(d) rank {rank} finite", all(math.isfinite(x["loss"]) for x in tr.history)))
    del tr
    section_done("(d) cli.train pp=2 1f1b")

    # ---- (e) the hosts' data rows; cli.train --dp 2 --tp 2 --multihost
    mesh = make_mesh(dp=2, tp=2, backend="gloo", device=DEVICE)
    rows = local_data_ranks(mesh)
    out["checks"].append((f"(e) rank {rank} local_data_ranks", rows == [rank // per_host]))
    log(f"(e) rank {rank} (host {rank // per_host}): local_data_ranks of the dp=2 x tp=2 mesh {rows}")
    argv = parallel_cli_argv() + ["--steps", "2", "--dp", "2", "--tp", "2", "--dist-backend", "gloo"]

    def fresh_multihost_run():
        # no process group when the CLI starts: its --multihost starts one from the launcher's environment
        dist.destroy_process_group()
        out["checks"].append((f"(e) rank {rank} no group before cli.train --multihost", not dist.is_initialized()))
        os.environ["MASTER_PORT"] = str(port2)
        return cli_train.main(argv + ["--multihost"])

    tr, c_mh, _ = measured("(e) cli.train --dp 2 --tp 2 --multihost: 2 steps", fresh_multihost_run, dist.group.WORLD)
    info2 = initialize_multihost(backend="gloo", device=DEVICE)
    out["checks"].append((f"(e) rank {rank} HostInfo of the group cli.train --multihost started", info2 == want_info))
    out["drives"][f"pipeline (e) cli.train dp=2 x tp=2 --multihost, 2 steps, rank {rank}"] = c_mh
    out["multihost_losses"] = [x["loss"] for x in tr.history]
    log(f"(e) rank {rank}: cli.train --dp 2 --tp 2 --multihost from no process group: group started on port "
        f"{port2}, {info2}; losses {out['multihost_losses']}")
    del tr
    section_done("(e) cli.train dp=2 x tp=2 --multihost")
    out["sections_s"]["whole rank"] = time.perf_counter() - t_entry
    with open(os.path.join(workdir, f"pp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    coll._call = real_call
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pp_phase(dev, one_loss: float, cli_losses: list) -> dict:
    """Phase 13 in the parent: the bins and the one-device references; the
    ranks (``pp_rank``, their logs printed here); (d) the ranks' cli.train
    --pp 2 step 1 against `one_loss` (phase 11's --dp 1) and its checkpoint
    resumed at --pp 1; (e) their --multihost losses against `cli_losses`
    (phase 11's --dp 2 --tp 2) and across the two hosts. Returns the ranks' drives {name: launches}
    summed over the ranks."""
    import gc
    import shutil
    import tempfile

    from dynamictreeattn_tpu_torch.cli import train as cli_train
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
    from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten, _unflatten
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    mc = MODEL_CONFIGS[MODEL]
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
                                            completion_len=(128, 512), branch_prob=0.85)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    try:
        # the Trainer's balancer (the cost model, not yet fitted) into PP_M and 2 PP_M bins; the one-device
        # step summed over each set of bins, the reference of the drives
        t0 = time.perf_counter()
        binner = Trainer(mc, EngineConfig(), TrainConfig(param_dtype="bf16"), device=dev)
        bins = {str(m): binner.partition_with_ids(seqs, attachs, n_bins=m)[1] for m in (PP_M, 2 * PP_M)}
        with open(os.path.join(workdir, "bins.json"), "w") as f:
            json.dump(bins, f)
        params = init_params(mc, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
        engine = TreeEngine(mc, EngineConfig(), device=dev)
        for m, b in bins.items():
            total, acc = 0.0, None
            for ids in b:
                loss, grads, _ = engine.loss_and_grad(params, engine.prepare(TokenTrie([seqs[i] for i in ids],
                                                                                      [attachs[i] for i in ids])))
                total += float(loss)
                leaves = [g.float() for g in _flatten(grads)[1]]
                acc = leaves if acc is None else [a.add_(g) for a, g in zip(acc, leaves)]
                del grads
            names = _flatten(params)[0]
            ref = _unflatten(params, names, [a.to(torch.bfloat16).cpu() for a in acc])
            torch.save({"loss": total, "grads": ref}, os.path.join(workdir, f"ref{m}.pt"))
            sizes = [sum(len(seqs[i]) for i in ids) for ids in b]
            log(f"phase 13 reference: {len(b)} bins of the bench rollouts ({sizes} dense tokens), the one-device "
                f"step (bwd \"auto\") summed: loss {total:.6f}")
            del acc, ref
        del params, engine, binner
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 13 references: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        port = _free_port()
        port2 = next(p for p in iter(_free_port, None) if p != port)
        logs = [open(os.path.join(workdir, f"log{r}.txt"), "w") for r in range(PP_WORLD)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--pp-rank", str(r), str(PP_WORLD),
                                   workdir, str(port), str(port2)], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(PP_WORLD)]
        deadline = time.monotonic() + PP_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        for p in procs:  # every process this phase started ends here
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        for r in range(PP_WORLD):
            with open(os.path.join(workdir, f"log{r}.txt")) as f:
                for line in f.read().splitlines():
                    if "FutureWarning" not in line and "return func(" not in line:
                        log(f"[rank {r}] {line}")
        if any(p.returncode for p in procs):
            fail(f"phase 13: a rank failed or timed out (exit codes {[p.returncode for p in procs]})")
        results = []
        for r in range(PP_WORLD):
            with open(os.path.join(workdir, f"pp_rank{r}.json")) as f:
                results.append(json.load(f))
        log(f"phase 13 ranks: {time.perf_counter() - t0:.1f} s for {PP_WORLD} processes sharing one card")
        for r, res in enumerate(results):
            for name, ok in res["checks"]:
                if not ok:
                    fail(f"phase 13 {name}: failed (rank {r}'s log above)")
        drives = {}
        for res in results:
            for name, counts in res["drives"].items():
                base = name.rsplit(", rank ", 1)[0]
                drives[base] = {key: drives.get(base, {}).get(key, 0) + v for key, v in counts.items()}
        for r, res in enumerate(results):
            log(f"rank {r}: seconds by section: " + ", ".join(f"{name} {t:.1f}" for name, t in
                                                           res["sections_s"].items()))
            for label, t in res["ms"].items():
                log(f"rank {r} of {PP_WORLD} ranks sharing one card (not a scaling number): {label} "
                    f"{t['step_ms']:.1f} ms, collectives {t['collective_ms']:.1f} ms ({json.dumps(t['collectives'])})")

        # (d) step 1 against --dp 1; the checkpoint resumed at --pp 1
        t0 = time.perf_counter()
        with open(os.path.join(workdir, "pp_cli.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        loss_rel = abs(recs[0]["loss"] - one_loss) / abs(one_loss)
        resumed = cli_train.main(parallel_cli_argv() + ["--steps", "1", "--ckpt-dir",
                                                        os.path.join(workdir, "pp_cli_ckpt"), "--resume"])
        log(f"(d) cli.train --pp 2 --pp-schedule 1f1b --microbatches 4 --dist-backend gloo, 2 steps in the ranks' "
            f"group: losses {[x['loss'] for x in recs]}; step 1 {recs[0]['loss']:.6f} vs --dp 1 {one_loss:.6f} (rel "
            f"{loss_rel:.3e}, tol {SP_LOSS_RTOL}); its checkpoint resumed at --pp 1: step {resumed.step_idx}, loss "
            f"{resumed.history[-1]['loss']:.6f}; {time.perf_counter() - t0:.1f} s in the parent")
        if (len(recs) != 2 or loss_rel > SP_LOSS_RTOL or resumed.step_idx != 3
                or not math.isfinite(resumed.history[-1]["loss"])):
            fail("phase 13 (d): cli.train --pp 2 disagrees with --dp 1 or does not resume at --pp 1")
        del resumed
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the two hosts' --multihost losses against each other and against phase 11's run of the same
        # argv: step 1 bit for bit; step 2 follows an update from K3's dq, summed in no fixed order
        mh = [res["multihost_losses"] for res in results]
        host1 = PP_WORLD // PP_HOSTS
        same_hosts = mh[0] == mh[host1]
        rel2 = abs(mh[0][1] - cli_losses[1]) / abs(cli_losses[1])
        log(f"(e) cli.train --dp 2 --tp 2 --multihost on 2 hosts x 2, from a fresh process group: losses {mh[0]} "
            f"(host 0) and {mh[host1]} (host 1); phase 11's run without --multihost {cli_losses}: step 1 bit-equal "
            f"{mh[0][0] == cli_losses[0]}, step 2 rel {rel2:.3e} (after an update from the \"cached\" backward, "
            f"whose dq sums in no fixed order); both hosts' losses bit-equal: {same_hosts}")
        if not same_hosts or mh[0][0] != cli_losses[0] or not all(math.isfinite(x) for x in mh[0]):
            fail("phase 13 (e): the --multihost run disagrees across hosts or with phase 11's run")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
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


def kernels_ab(root: str, iters: int = 20) -> None:
    """``--kernels-only [--root DIR]``: the tree-attention kernels K1, K2,
    K11, K12, K3 and K10 at offset 0 on MODEL's main-path shape (the bench
    trie; random bf16 q, k, v, do; the batch's own work lists), each the
    mean of `iters` launches (``cuda_ms``: CUDA events, cold L2), from the
    port under `root` (as in ``steps_ab``); builds the kernels of that
    checkout. Uses only entry points both commits have; prints one JSON
    line."""
    sys.path.insert(0, os.path.abspath(root))
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.ops import _build
    import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module, not the function)
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
    _build.build()
    dev = torch.device(DEVICE)
    mc = MODEL_CONFIGS[MODEL]
    seqs, attachs = synthetic_rollout_batch(
        seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
        completion_len=(128, 512), branch_prob=0.85,
    )
    ec = EngineConfig()
    b = TreeEngine(mc, ec, device=dev).prepare(TokenTrie(seqs, attachs))
    hkv, dh, n = mc.num_key_value_heads, mc.head_dim, b.n_padded
    gen = torch.Generator(device=dev).manual_seed(0)
    q4, do = (torch.randn(hkv, mc.num_attention_heads // hkv, n, dh, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    k, v = (torch.randn(hkv, n, dh, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    scale, bq, bkv, m, ld = dh**-0.5, ec.block_q, ec.block_kv, b.meta, b.last_desc
    c = ta._score_bound(q4, k, scale)
    o, lse = ta.tree_attn_fwd_online(q4, k, v, ld, *m[:3], scale, bq, bkv, work=b.qmajor_work)
    tail = (do, lse, torch.sum(do.float() * o.float(), -1), scale, bq, bkv)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    runs = {
        "K1": lambda: ta.tree_attn_fwd_bound(q4, k, v, ld, *m[:3], scale, bq, bkv, c, work=b.qmajor_work),
        "K2": lambda: ta.tree_attn_fwd_online(q4, k, v, ld, *m[:3], scale, bq, bkv, work=b.qmajor_work),
        "K11": lambda: ta.tree_attn_bwd_dq(q4, k, v, ld, *m[:3], *tail, work=b.qmajor_work),
        "K12": lambda: ta.tree_attn_bwd_dkv(q4, k, v, ld, *m[3:6], *tail, work=b.kmajor_work),
        "K3": lambda: ta.tree_attn_bwd_cached(q4, k, v, ld, *m[:6], None, None, *tail, work=b.kmajor_work),
        "K10": lambda: ta.tree_attn_bwd_fused(q4, k, v, ld, *m[:3], *tail, work=b.kmajor_work),
    }
    print(json.dumps({"root": root, "card": smi_line(), "n": n,
                      **{name: cuda_ms(fn, iters, flush) for name, fn in runs.items()}}), flush=True)


def profiler_probe(traces: int, after_warmup: bool) -> None:
    """``--profiler-probe N [--after-warmup]``: how often a short
    ``torch.profiler`` trace loses device events, in a process of its own:
    N traces each of one K6 and one K7 call at phase 2's Llama-3.2-3B
    no-norm case (24 / 8 heads, dh 128, 6606 rows), each bracketed by the
    marker kernels of ``traced_names``; with ``--after-warmup`` a
    ``cli.warmup`` process runs first, as phase 1 runs it. Counts the
    traces that hold no device event, that lack a marker, and that hold
    both markers but not exactly one qk_prep_bwd_kernel between them.
    Prints one JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.models.qwen3 import rope_tables
    from dynamictreeattn_tpu_torch.ops import _build
    import dynamictreeattn_tpu_torch.ops.qk_prep as qp

    _build.build()
    t0 = time.perf_counter()
    if after_warmup:
        subprocess.run([sys.executable, "-m", "dynamictreeattn_tpu_torch.cli.warmup", "--model", MODEL],
                       capture_output=True, text=True, timeout=600, check=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    warm_s = time.perf_counter() - t0
    dev = torch.device(DEVICE)
    cfg = MODEL_CONFIGS["llama-3.2-3b"]
    hq, hkv, dh, n = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, 6606
    gen = torch.Generator(device=dev).manual_seed(0)
    cos, sin = rope_tables(torch.arange(n, device=dev), dh, cfg.rope_theta, cfg.rope_scaling_tuple)
    q, k = (torch.randn((n, h * dh), generator=gen, device=dev).to(torch.bfloat16) for h in (hq, hkv))
    gq, gk, gv = (torch.randn((h, n, dh), generator=gen, device=dev).to(torch.bfloat16) for h in (hq, hkv, hkv))
    ones = torch.ones(dh, dtype=torch.bfloat16, device=dev)
    calls = {"qk_prep_bwd_q": lambda: qp.qk_prep_bwd_q(gq, q, ones, cos, sin, cfg.rms_norm_eps, False),
             "qk_prep_bwd_kv": lambda: qp.qk_prep_bwd_kv(gk, gv, k, ones, cos, sin, cfg.rms_norm_eps, False)}
    for call in calls.values():  # the first call allocates the dw counters
        call()
    counts = {name: {"traces": traces, "empty": 0, "marker_lost": 0, "kernel_wrong": 0, "lost_examples": []}
              for name in calls}
    t0 = time.perf_counter()
    for i in range(traces):
        for name, call in calls.items():
            names = traced_names(call)
            c = counts[name]
            if not names:
                c["empty"] += 1
            elif not whole_trace(names):
                c["marker_lost"] += 1
            elif len(names) != 3 or "qk_prep_bwd_kernel" not in names[1]:
                c["kernel_wrong"] += 1
            if (not whole_trace(names) or len(names) != 3) and len(c["lost_examples"]) < 3:
                c["lost_examples"].append([i, names])
    print(json.dumps({"card": smi_line(), "torch": torch.__version__, "after_warmup": after_warmup,
                      "warmup_s": warm_s, "trace_s": time.perf_counter() - t0, "counts": counts}), flush=True)


def prepare_ab(root: str, iters: int = 11) -> None:
    """``--prepare-only [--root DIR]``: the host ms of ``Trainer.prepare_step``
    (partition, stack, upload; synchronised) for MODEL on the bench trie,
    from the port under `root` (as in ``steps_ab``), one warm-up then
    `iters` timed calls; builds no kernel. Prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

    dev = torch.device(DEVICE)
    seqs, attachs = synthetic_rollout_batch(
        seed=0, n_prompts=1, samples_per_prompt=16, prompt_len=(1024, 2048),
        completion_len=(128, 512), branch_prob=0.85,
    )
    tr = Trainer(MODEL_CONFIGS[MODEL], EngineConfig(remat_policy="attn"), TrainConfig(), device=dev)
    ms = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        tr.prepare_step(seqs, attachs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    import dynamictreeattn_tpu_torch

    print(json.dumps({"root": root, "package": dynamictreeattn_tpu_torch.__file__, "card": smi_line(),
                      "prepare_step_ms": sorted(ms[1:])[iters // 2], "runs_ms": ms[1:]}), flush=True)


ADAMW_CONFIGS = ("qwen3-0.6b", "qwen3-30b-a3b-8l")
ADAMW_NORM_REL = 1e-6  # the sum of squares' root against the eager fp32 norm
ADAMW_TARGET = 0.70  # the share of the byte bound the layer should reach at the 30B-8l leaves (printed)


def adamw_layouts(name: str) -> list:
    """(shape, strides) of each leaf of `name`'s params ("-8l": 8 layers),
    from ``init_params`` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
    from dynamictreeattn_tpu_torch.training.trainer import _leaves

    base = name.removesuffix("-8l")
    mc = MODEL_CONFIGS[base]
    if name != base:
        mc = dataclasses.replace(mc, num_hidden_layers=8)
    with FakeTensorMode():
        params = init_params(mc, torch.Generator(), torch.bfloat16)
    return [(tuple(t.shape), t.stride()) for t in _leaves(params)]


def adamw_draw(layout, seed: int, dev) -> tuple:
    """(p, g, mu, nu) bf16 of one leaf in `layout`, seeded; nu >= 0."""
    shape, stride = layout
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [torch.randn(math.prod(shape), generator=gen, device=dev, dtype=torch.bfloat16).mul_(scale)
           .as_strided(shape, stride) for scale in (0.02, 1e-3, 1e-4, 1e-3)]
    out[3].mul_(out[3])
    return tuple(out)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def adamw_trainer_launches(dev) -> tuple[dict, int]:
    """(launches from 0, host synchronisations) of one ``Trainer`` step at
    MODEL on a small batch, after its stacking."""
    import warnings

    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

    mc = MODEL_CONFIGS[MODEL]
    tr = Trainer(mc, EngineConfig(), TrainConfig(grad_clip=1.0, learning_rate=TRAINER_LR), device=dev)
    tr.init(0)
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=1, samples_per_prompt=4, prompt_len=(192, 256),
                                            completion_len=(32, 64), vocab_size=mc.vocab_size)
    batch, tries = tr.prepare_step(seqs, attachs)
    _build.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.run_step(batch, tries, len(seqs), int(sum(len(s) for s in seqs)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts = _build.launches()
    del tr
    return counts, sum("synchroniz" in str(w.message) for w in caught)


def adamw_phase(dev, flush) -> tuple[list[dict], dict]:
    """Phase 10b (the module docstring): (kernel rows, {drive: launches})."""
    import gc

    from dynamictreeattn_tpu_torch.ops import _build, adamw
    from dynamictreeattn_tpu_torch.training import OptaxAdamW

    rows = []
    for name in ADAMW_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        layouts = adamw_layouts(name)
        leaves = [adamw_draw(lay, i, dev) for i, lay in enumerate(layouts)]
        ps, gs, ms, vs = (list(t) for t in zip(*leaves))
        n = sum(g.numel() for g in gs)
        # A2: two runs, the eager fp32 norm, an fp64 sum
        ss, again = adamw.sum_squares(gs), adamw.sum_squares(gs)
        eager = float(torch.sqrt(adamw.sum_squares_plain(gs)))
        exact = math.sqrt(sum(float(c.double().square().sum()) for g in gs for c in g.reshape(-1).split(1 << 26)))
        norm = math.sqrt(float(ss))
        rel_eager, rel_exact = abs(norm - eager) / eager, abs(norm - exact) / exact
        log(f"A2 sum of squares at {name} ({len(gs)} leaves, {n:,} parameters): norm {norm!r}, eager fp32 "
            f"{eager!r} (rel {rel_eager:.3e}), fp64 {exact!r} (rel {rel_exact:.3e}; eager's "
            f"{abs(eager - exact) / exact:.3e}); two runs bit-equal {torch.equal(ss, again)}")
        if not torch.equal(ss, again) or rel_eager > ADAMW_NORM_REL:
            fail(f"A2 at {name}: rel {rel_eager:.3e} to the eager norm (limit {ADAMW_NORM_REL}) or two runs differ")
        # A1: every leaf in one launch, then each leaf against the plain version
        f32 = dict(dtype=torch.float32, device=dev)
        count = torch.tensor(3.0, **f32)
        kw = dict(lr=torch.tensor(-1e-3, **f32), bc1=1 - torch.pow(0.9, count), bc2=1 - torch.pow(0.999, count),
                  commit=torch.tensor(True, device=dev), clip=(torch.sqrt(ss), torch.ones((), **f32)), b1=0.9,
                  b2=0.999, eps=1e-8, weight_decay=0.01)
        _build.reset_launches()
        adamw.adamw_update(ps, gs, ms, vs, **kw)
        a1_launches = _build.launches()["adamw_update"]
        torch.cuda.synchronize()
        bad = []
        for i, lay in enumerate(layouts):
            want = adamw_draw(lay, i, dev)
            g_kept = _bits_equal(gs[i], want[1])
            adamw.adamw_update_plain(*([t] for t in want), **kw)
            same = [_bits_equal(a, b) for a, b in zip((ps[i], ms[i], vs[i]), (want[0], want[2], want[3]))]
            if not (g_kept and all(same)):
                j = next(k for k, ok in enumerate(same) if not ok) if not all(same) else 0
                got, ref = (ps[i], ms[i], vs[i])[j], (want[0], want[2], want[3])[j]
                diff = (got.view(torch.int16) != ref.view(torch.int16)).reshape(-1)
                first = int(diff.nonzero()[0]) if diff.any() else -1
                bad.append(f"leaf {i} {lay[0]}: g kept {g_kept}, p/mu/nu equal {same}, {int(diff.sum())} "
                           f"elements of {'p mu nu'.split()[j]} differ, first at {first}: "
                           f"{got.reshape(-1)[first].item()!r} vs {ref.reshape(-1)[first].item()!r}")
            del want
        log(f"A1 update at {name}: {a1_launches} launch(es) for {len(layouts)} leaves; bit-equal to the plain "
            f"version leaf by leaf: {not bad}" + "".join(f"\n  {b}" for b in bad))
        if bad or a1_launches != 1:
            fail(f"A1 at {name}: {len(bad)} leaves differ from the plain version, {a1_launches} launches")
        # times: the kernels, the layer as the Trainer runs it, the plain versions
        opt = OptaxAdamW(1e-5, grad_clip=1.0)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        state = {"count": zero, "mini_step": zero, "gradient_step": zero, "mu": ms, "nu": vs, "acc": None}
        pd, gd = dict(enumerate(ps)), dict(enumerate(gs))
        good = torch.tensor(True, device=dev)
        a1_ms = cuda_ms(lambda: adamw.adamw_update(ps, gs, ms, vs, **kw), 5, flush)
        a2_ms = cuda_ms(lambda: adamw.sum_squares(gs), 5, flush)
        layer_ms = cuda_ms(lambda: opt.update(gd, state, pd, good), 5, flush)
        plain_a2 = cuda_ms(lambda: adamw.sum_squares_plain(gs), 2, flush)
        plain_a1 = cuda_ms(lambda: adamw.adamw_update_plain(ps, gs, ms, vs, **kw), 2, flush)
        nbytes = 2 * n  # bf16: one pass over every parameter
        bound = {"A1": 7 * nbytes / PEAK_HBM_BYTES * 1e3, "A2": nbytes / PEAK_HBM_BYTES * 1e3,
                 "layer": 8 * nbytes / PEAK_HBM_BYTES * 1e3}
        log(f"optimizer layer at {name}: OptaxAdamW.update {layer_ms:.3f} ms against its byte bound "
            f"{bound['layer']:.3f} ms (16 bytes a parameter at 3.35 TB/s): {bound['layer'] / layer_ms:.3f} of it"
            + (f" (target {ADAMW_TARGET})" if name.endswith("-8l") else "")
            + f"; A1 {a1_ms:.3f} ms ({bound['A1'] / a1_ms:.3f} of {bound['A1']:.3f}), A2 {a2_ms:.3f} ms "
            f"({bound['A2'] / a2_ms:.3f} of {bound['A2']:.3f}); plain: update {plain_a1:.2f} ms, sum of squares "
            f"{plain_a2:.2f} ms")
        suffix = "" if name == MODEL else f"@{name}"
        shape = {"config": name, "leaves": len(layouts), "parameters": n, "dtype": "bf16"}
        for kid, kname, k_ms, plain_ms, err in (("A1", "adamw_update", a1_ms, plain_a1, 0.0),
                                                ("A2", "adamw_sum_squares", a2_ms, plain_a2, rel_eager)):
            rows.append({"name": kname + suffix, "id": kid, "route": "cuda",
                         "source": "dynamictreeattn_tpu_torch/csrc/adamw.cu",
                         "replaces": "none (optax's chain, fused by XLA on the TPU)", "launches": 0,
                         "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound[kid],
                         "bound_by": "bytes", "bound_fraction": bound[kid] / k_ms, "library_ms": None,
                         "layer_ms": layer_ms, "layer_bound_ms": bound["layer"], "shape": shape})
        del leaves, ps, gs, ms, vs, pd, gd, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    counts, syncs = adamw_trainer_launches(dev)
    got = {k: counts[k] for k in ("adamw_update", "adamw_sum_squares")}
    log(f"one Trainer step at {MODEL}: optimizer launches {got} (the step's launches "
        f"{ {k: v for k, v in counts.items() if v} }); host synchronisations {syncs} (the step's one read)")
    if got != {"adamw_update": 1, "adamw_sum_squares": 2} or syncs != 1:
        fail(f"a Trainer step launched {got} with {syncs} host synchronisations: expected one A1, two A2, one read")
    return rows, {"adamw trainer step": counts}


def adamw_only() -> None:
    """``--adamw-only``: every source built (the AdamW source's ptxas
    lines), phase 10b, the rows as one JSON line and the card line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamictreeattn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build()  # every source at once: the Trainer step runs them all
    for kernel, usage in ptxas_usage(reports.get("adamw", "")):
        log(f"  ptxas[adamw] {kernel}: {usage}")
    log(f"build: {time.perf_counter() - t0:.2f} s")
    dev = torch.device(DEVICE)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows, _ = adamw_phase(dev, flush)
    log(f"run: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi_line(), flush=True)


MLA_LAYERS = 9  # Moonlight-16B-A3B's first 9 of 27 layers, the benchmark's cut


def mla_trainer_launches(dev) -> dict:
    """Launches from 0 of one ``Trainer`` step at Moonlight-16B-A3B's first
    MLA_LAYERS layers (random weights) on the two-prompt GRPO trie, the
    benchmark cell's job (remat, clip 1.0), after a first step that builds
    and warms everything."""
    import gc

    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.models.deepseek_v3 import DeepseekV3Config
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

    mc = DeepseekV3Config(num_hidden_layers=MLA_LAYERS)
    tr = Trainer(mc, EngineConfig(remat=True), TrainConfig(grad_clip=1.0, learning_rate=1e-5), device=dev)
    tr.init(0)
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=2, samples_per_prompt=16, prompt_len=(1024, 2048),
                                            completion_len=(128, 512), branch_prob=0.85, vocab_size=mc.vocab_size)
    tr.train_step(seqs, attachs)
    torch.cuda.synchronize()
    _build.reset_launches()
    rec = tr.train_step(seqs, attachs)
    counts = _build.launches()
    log(f"one Trainer step at Moonlight-16B-A3B-{MLA_LAYERS}l (loss {rec['loss']:.6f}): launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    want = {"tree_attn_bwd_cached": MLA_LAYERS, "adamw_update": 1, "adamw_sum_squares": 2}
    fwd = counts["tree_attn_fwd_online"] + counts["tree_attn_fwd_bound"]
    if any(counts[k] != v for k, v in want.items()) or fwd < MLA_LAYERS or not math.isfinite(rec["loss"]):
        fail(f"Moonlight Trainer step: launches {counts} (forward {fwd}), loss {rec['loss']}: expected K3 once a "
             f"layer, one A1, two A2, K1/K2 at least once a layer")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def mla_phase(dev, flush) -> tuple[list[dict], dict]:
    """Phase 10c (the module docstring): the tree-attention kernels at
    MLA's widths checked and timed, and one Moonlight-16B-A3B Trainer step's
    launches: (kernel rows, {drive: launches}). Inputs N(0, 1) in bf16
    (MLA's q and k at random init are about that: projections of RMS-normed
    rows by N(0, 1/fan_in) weights), the output cotangent N(0, 1)."""
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
    from dynamictreeattn_tpu_torch.models.deepseek_v3 import DeepseekV3Config
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
    t0 = time.perf_counter()
    mc = DeepseekV3Config(num_hidden_layers=MLA_LAYERS)
    ec = EngineConfig()
    engine = TreeEngine(mc, ec, device=dev)
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=2, samples_per_prompt=16, prompt_len=(1024, 2048),
                                            completion_len=(128, 512), branch_prob=0.85)
    batch = engine.prepare(TokenTrie(seqs, attachs))
    n, H, (dqk, dv) = batch.n_padded, mc.num_attention_heads, mc.attn_widths
    if batch.qmajor_work is None or batch.kmajor_work is None:
        fail("prepare built no work list at MLA's widths")
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q4, k, v, do = draw(H, 1, n, dqk), draw(H, n, dqk), draw(H, n, dv), draw(H, 1, n, dv)
    ld, meta, bq, bkv, scale = batch.last_desc, batch.meta, ec.block_q, ec.block_kv, dqk ** -0.5
    qwork, kwork = batch.qmajor_work, batch.kmajor_work
    args = (ld, *meta[:3], scale, bq, bkv)
    rows, errs = [], {}
    with torch.inference_mode():
        c = ta._score_bound(q4, k, scale)
        o2, lse2 = ta.tree_attn_fwd_online(q4, k, v, *args, work=qwork)
        o2p, lse2p = ta.tree_attn_fwd_plain(q4, k, v, *args)
        o1, lse1 = ta.tree_attn_fwd_bound(q4, k, v, *args, c, work=qwork)
        o1p, lse1p = ta.tree_attn_fwd_plain(q4, k, v, *args, c=c)
        again = ta.tree_attn_fwd_online(q4, k, v, *args, work=qwork)
        torch.cuda.synchronize()
        if o2.shape != (H, 1, n, dv) or not (torch.equal(o2, again[0]) and torch.equal(lse2, again[1])):
            fail(f"K2 at MLA's widths: o {tuple(o2.shape)}, or two launches differ")
        errs.update({"K2 o": check_close("MLA K2 o", o2, o2p, ATTN_O_ATOL, ATTN_O_RTOL),
                     "K2 lse": check_close("MLA K2 lse", lse2, lse2p, ATTN_LSE_ATOL),
                     "K1 o": check_close("MLA K1 o", o1, o1p, ATTN_O_ATOL, ATTN_O_RTOL),
                     "K1 lse": check_close("MLA K1 lse", lse1, lse1p, ATTN_LSE_ATOL)})
        di = torch.sum(do.float() * o2.float(), dim=-1)
        tail = (do, lse2, di, scale, bq, bkv)
        dq_p, dk_p, dv_p = ta.tree_attn_bwd_fused_plain(q4, k, v, ld, *meta[:3], *tail)
        got = [ta.tree_attn_bwd_cached(q4, k, v, ld, *meta[:6], None, None, *tail, work=kwork) for _ in range(2)]
        got.append(ta.tree_attn_bwd_fused(q4, k, v, ld, *meta[:3], *tail, work=kwork))
        torch.cuda.synchronize()
        for kid, (dq_, dk_, dv_) in zip(("K3", "K3 again", "K10"), got):
            if dq_.shape != q4.shape or dk_.shape != k.shape or dv_.shape != v.shape:
                fail(f"MLA {kid}: shapes {tuple(dq_.shape)} {tuple(dk_.shape)} {tuple(dv_.shape)}")
            for name, g_, w_ in (("dq", dq_, dq_p), ("dk", dk_, dk_p), ("dv", dv_, dv_p)):
                errs[f"{kid} {name}"] = check_rel(f"MLA {kid} {name}", g_, w_, BWD_REL_TOL)
        if not (torch.equal(got[0][1], got[1][1]) and torch.equal(got[0][2], got[1][2])):
            fail("MLA K3: dk/dv of two launches differ (they sum in a fixed order)")
        for fn, meta_, what in ((ta.tree_attn_bwd_dkv, meta[3:6], "K12"), (ta.tree_attn_bwd_dq, meta[:3], "K11")):
            try:
                fn(q4, k, v, ld, *meta_, *tail, work=kwork if what == "K12" else qwork)
            except ValueError as err:
                log(f"MLA {what} refused: {err}")
            else:
                fail(f"MLA {what} ran at (192, 128)")
    log(f"MLA attention at q4 {tuple(q4.shape)}, v {tuple(v.shape)}, n={n} ({len(seqs)} seqs), max C "
        f"{float(c.max()):.2f}: " + ", ".join(f"{key} max|err| {val:.3e}" for key, val in errs.items())
        + f" (o tol {ATTN_O_ATOL}+{ATTN_O_RTOL}*|ref|, lse {ATTN_LSE_ATOL}, grads {BWD_REL_TOL}*max|ref|); "
          "K2 and K3's dk/dv bit-equal across launches")
    pairs = unmasked_pairs(ld, n)
    fwd_flops = 2.0 * H * (dqk + dv) * pairs
    fwd_bytes = 2 * H * n * (2 * dqk + 2 * dv) + 4 * H * n + 4 * n
    bwd_flops = 2.0 * H * (3 * dqk + 2 * dv) * pairs
    bwd_bytes = 2 * H * n * (2 * dqk + 2 * dv) + 8 * H * n + 4 * n + 2 * H * n * (2 * dqk + dv)
    with torch.inference_mode():
        timed = {
            "tree_attn_fwd_mla (K2 online)": (lambda: ta.tree_attn_fwd_online(q4, k, v, *args, work=qwork),
                                              fwd_flops, fwd_bytes, lambda: ta.tree_attn_fwd_plain(q4, k, v, *args)),
            "tree_attn_fwd_mla (K1 bound)": (lambda: ta.tree_attn_fwd_bound(q4, k, v, *args, c, work=qwork),
                                             fwd_flops, fwd_bytes + 4 * H * n, None),
            "tree_attn_bwd_kmajor_mla (K3)": (
                lambda: ta.tree_attn_bwd_cached(q4, k, v, ld, *meta[:6], None, None, *tail, work=kwork),
                bwd_flops, bwd_bytes, lambda: ta.tree_attn_bwd_fused_plain(q4, k, v, ld, *meta[:3], *tail)),
        }
        for name, (fn, flops, nbytes, plain) in timed.items():
            ms = cuda_ms(fn, 10, flush)
            bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
            plain_ms = cuda_ms(plain, 1, flush) if plain is not None else None
            rows.append({"kernel": name, "ms": ms, "bound_ms": bound, "share": bound / ms, "plain_ms": plain_ms,
                         "pairs": pairs, "n": n})
            log(f"{name}: {ms:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}%), plain "
                f"{'-' if plain_ms is None else f'{plain_ms:.1f}'} ms")
    del q4, k, v, do, got, o1, o2, o1p, o2p, dq_p, dk_p, dv_p, engine, batch
    log(f"MLA kernels: {time.perf_counter() - t0:.1f} s")
    return rows, {f"moonlight-16b-a3b-{MLA_LAYERS}l trainer step": mla_trainer_launches(dev)}


def mla_only() -> None:
    """``--mla-only``: every source built (the ptxas lines of the MLA
    instantiations), phase 10c, its rows and launches as one JSON line and
    the card line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamictreeattn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build()
    for src in ("tree_attn_fwd", "tree_attn_bwd_kmajor"):
        for kernel, usage in ptxas_usage(reports.get(src, "")):
            if "mla" in kernel:
                log(f"  ptxas[{src}] {kernel}: {usage}")
    log(f"build: {time.perf_counter() - t0:.2f} s")
    dev = torch.device(DEVICE)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows, drives = mla_phase(dev, flush)
    log(f"run: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"mla_kernels": rows, "mla_launches": drives}))
    print(smi_line(), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    root = (sys.argv[sys.argv.index("--root") + 1] if "--root" in sys.argv else
            os.path.dirname(os.path.abspath(__file__)))
    if "--steps-only" in sys.argv:
        steps_ab(root)
        return 0
    if "--kernels-only" in sys.argv:
        kernels_ab(root)
        return 0
    if "--prepare-only" in sys.argv:
        prepare_ab(root)
        return 0
    if "--adamw-only" in sys.argv:
        adamw_only()
        return 0
    if "--mla-only" in sys.argv:
        mla_only()
        return 0
    if "--profiler-probe" in sys.argv:
        profiler_probe(int(sys.argv[sys.argv.index("--profiler-probe") + 1]), "--after-warmup" in sys.argv)
        return 0
    if "--parallel-rank" in sys.argv:
        i = sys.argv.index("--parallel-rank")
        parallel_rank(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3])
        return 0
    if "--sp-rank" in sys.argv:
        i = sys.argv.index("--sp-rank")
        sp_rank(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3])
        return 0
    if "--pp-rank" in sys.argv:
        i = sys.argv.index("--pp-rank")
        pp_rank(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3], int(sys.argv[i + 4]),
                int(sys.argv[i + 5]))
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
    # (f) the warmup CLI as a user runs it: its build finds every source built
    proc = subprocess.run([sys.executable, "-m", "dynamictreeattn_tpu_torch.cli.warmup", "--model", MODEL],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        log(proc.stdout[-3000:] + proc.stderr[-3000:])
        fail(f"cli.warmup --model {MODEL} exited {proc.returncode}")
    else:
        warm = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"(f) cli.warmup --model {MODEL}: {warm['seconds']:.2f} s (build {warm['build_s']:.2f} s, sources built "
            f"{warm['sources_built']}; load {warm['load_s']:.2f} s); instantiations "
            + "; ".join(f"{i['name']} {json.dumps(i['shape'])}" for i in warm["instantiations"])
            + f"; launches {json.dumps(warm['launches'])}")
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

    log(f"device_kernels: {len(PROFILER_RETRACES)} trace(s) taken again after a lost marker")
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
    # ---- 8. the RL loop and the grad-parity protocol
    rl_drives = rl_phase(params, mc, seqs, attachs, engine, mode_engines["split"], tree_batch, dense_batch)
    phase_done("8 (RL loop, custom loss, grad-parity protocol)")
    # ---- 9. the single-card trainer: remat settings, Trainer, checkpoint, memory probe
    trainer_drives = trainer_phase(params, mc, dev, tree_batch, seqs, attachs)
    phase_done(f"9 (trainer: remat settings, Trainer, cli.train checkpoint, {PROBE_MODEL} probe)")
    # ---- 10. the Qwen3-MoE family at Qwen3-30B-A3B's full width, then K8 /
    # K9 at its hidden size and untied head (random bf16 inputs at the bench
    # trie's n, the head scaled as init_params scales it)
    del params, tree_batch, dense_batch
    moe_drives = moe_phase(seqs, attachs, dev, flush)
    mmc = MODEL_CONFIGS[MOE_MODEL]
    gen = torch.Generator(device=dev).manual_seed(6)
    h30 = torch.randn(n, mmc.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
    w30 = (torch.randn(mmc.vocab_size, mmc.hidden_size, generator=gen, device=dev)
           * mmc.hidden_size**-0.5).to(torch.bfloat16).t()
    kernels += lm_head_rows(h30, w30, *torch.randn(2, n, generator=gen, device=dev), flush, config=MOE_MODEL)
    del h30, w30
    phase_done(f"10 ({MOE_MODEL}: scoring forward, rollout, training steps, Trainer, HF bridge; K8/K9 at d=2048)")
    adamw_rows, adamw_drives = adamw_phase(dev, flush)
    kernels += adamw_rows
    phase_done("10b (the optimizer layer: A1, A2 at Qwen3-0.6B's and Qwen3-30B-A3B-8l's leaves)")
    gc.collect()
    torch.cuda.empty_cache()
    mla_rows, mla_drives = mla_phase(dev, flush)
    phase_done(f"10c (latent attention: K1/K2, K3/K10 at (192, 128); a Moonlight-16B-A3B-{MLA_LAYERS}l Trainer step)")
    parallel_drives, one_loss, cli_losses = parallel_phase(dev)
    phase_done(f"11 (data, tensor, vocab and expert parallelism: {PARALLEL_WORLD} ranks over gloo on one card)")
    sp_drives, ring = sp_phase(dev, flush, seqs, attachs, one_loss)
    phase_done(f"12 (ZeRO-3, Ulysses and ring sequence parallelism: {SP_WORLD} ranks over gloo on one card)")
    pp_drives = pp_phase(dev, one_loss, cli_losses)
    phase_done(f"13 (pipeline parallelism, GPipe and 1F1B; multi-host: {PP_WORLD} ranks as {PP_HOSTS} hosts over gloo "
               "on one card)")

    # launches over the drives, each from counts of 0: the forward path, the
    # training path (tree + dense step, default backward), the tree step in
    # each other backward mode, the sampler (one sampled rollout), and the
    # same four training drives of the second family. A row at another
    # shape ("name@config") counts the drives of its config only.
    drives = {"forward path": launches, "training path": train_launches,
              "split step": mode_launches["split"], "fused step": mode_launches["fused"],
              "sampler": sampler_launches, **family_drives, **rl_drives, **trainer_drives, **moe_drives,
              **parallel_drives, **sp_drives, **pp_drives, **adamw_drives}
    # K2, K11 and K12 also run with position offsets (the ring's pairs,
    # phase 12): each pair's ms and the worst error against plain
    offset_errs = {"K2": max(ring["max_abs_err"]["K2 o"], ring["max_abs_err"]["K2 lse"]),
                   "K11": ring["max_abs_err"]["K11 dq"],
                   "K12": max(ring["max_abs_err"]["K12 dk"], ring["max_abs_err"]["K12 dv"])}
    for kd in kernels:
        if kd["id"] in offset_errs and "@" not in kd["name"]:
            kd["offsets"] = {"run": f"ring pairs (q_off, kv_off) of sp={ring['sp']} on the bench trie (n {ring['n']})",
                             "empty_pairs": ring["empty"], "max_abs_err": offset_errs[kd["id"]],
                             "ms_by_pair": {f"({p['me']},{p['src']})": p["ms"][kd["id"]] for p in ring["pairs"]}}
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
        parent = BWD_PARENT_MS.get((shape["head_dim"], shape["group"]))
        if parent is None:
            continue
        old = parent[kd["id"] == "K10"]
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
    print(json.dumps({"mla_kernels": mla_rows, "mla_launches": mla_drives}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
