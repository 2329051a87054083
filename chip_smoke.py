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
   dispatch; the LM-head statistics (K8) on the trie's final hidden states;
3. drive the main path — Qwen3-0.6B at full width (28 layers, d=1024, 16/8
   heads, V=151936, bf16, random weights from seed 0) through
   ``TreeEngine.prepare`` -> ``TreeEngine.forward`` on the 1-group rollout
   trie of bench.py and on its dense packing (plus one tree forward with the
   online softmax, the path that runs K2) — and check tree == dense
   log-probs, a reference on a small input, and that every kernel launched;
4. time the forwards and each kernel beside its bound, its plain version
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
    (a 64 MB buffer is rewritten before each, outside the timed events)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def check_close(name, got, ref, atol, rtol=0.0) -> float:
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside |diff| <= {atol} + {rtol}*|ref|, "
             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def attention_work(last_desc: torch.Tensor, hq: int, hkv: int, dh: int, n: int, bound: bool):
    """(flops, bytes) the tree-attention forward needs for these inputs:
    4*dh flops per unmasked (q, k) pair per q head; q/k/v read once, o and
    lse written once, plus the mask and metadata reads."""
    pairs = int((last_desc.long() - torch.arange(n, device=last_desc.device) + 1).sum())
    flops = 4.0 * dh * hq * pairs
    nbytes = 2 * (hq + 2 * hkv + hq) * n * dh + 4 * hq * n + 4 * n
    if bound:
        nbytes += 4 * hq * n  # C
    return flops, nbytes


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _kernel_layer(name: str) -> str:
    if "tree_attn_fwd" in name:
        return "tree attention (K1/K2)"
    if "lm_stats" in name:
        return "LM-head stats (K8)"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmuls (cuBLAS)"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies"
    return "elementwise / norms / rope / gathers"


def profile_forward(run, label: str) -> None:
    """One traced run: device time by layer, top kernels, and the device's
    idle share of the host-clock wall time."""
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
        return
    layers: dict[str, float] = {}
    for name, ms in by_name.items():
        layers[_kernel_layer(name)] = layers.get(_kernel_layer(name), 0.0) + ms
    log(f"profile {label}: wall {wall_ms:.2f} ms (traced), device busy {busy:.2f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}")
    for layer, ms in sorted(layers.items(), key=lambda kv: -kv[1]):
        log(f"  layer {layer}: {ms:.2f} ms ({ms / busy:.3f} of busy)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  kernel {name[:90]}: {ms:.2f} ms")


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
    import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module, not the function)
    ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
    from dynamictreeattn_tpu_torch.ops.lm_stats import lm_stats, lm_stats_plain
    from dynamictreeattn_tpu_torch.tries import TokenTrie

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
    tree_batch = engine.prepare(TokenTrie(seqs, attachs))
    dense_batch = engine.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=ec.pad_multiple))
    n = tree_batch.n_padded
    log(f"workload: {len(seqs)} seqs, {n_dense_tokens} dense tokens, sharing "
        f"{sharing_ratio(seqs):.4f}, tree {tree_batch.packed.n_tokens} -> padded {n}, "
        f"dense padded {dense_batch.n_padded}, blocks {ec.block_q}/{ec.block_kv}")

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
        attn_args = (ld, *meta, scale, bq, bkv)
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
            od, lsed = ta._fwd_dispatch(qq, k, v, ld, *meta, scale, ta.BlockSizes(bq, bkv), "bound")
            moved = [key for key, val in _build.LAUNCHES.items() if val]
            if moved != [want]:
                fail(f"dispatch with {label} launched {moved}, expected [{want}]")
            op, lsep = ta.tree_attn_fwd_plain(qq, k, v, *attn_args)
            e_o = check_close(f"dispatch {label} o", od, op, ATTN_O_ATOL, ATTN_O_RTOL)
            e_l = check_close(f"dispatch {label} lse", lsed, lsep, ATTN_LSE_ATOL)
            log(f"dispatch {label}: took {want}, o max|err| {e_o:.3e}, lse max|err| {e_l:.3e}")

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

    # ---- 3. main path: counts from 0, drive, read
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    lp_tree = engine.forward(params, tree_batch)
    lp_dense = engine.forward(params, dense_batch)
    lp_online = online_engine.forward(params, tree_batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path launches: {launches}")
    missing = [key for key, val in launches.items() if val == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

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

    # ---- 4. timings
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
    log(f"forward: tree {tree_ms:.2f} ms, dense {dense_ms:.2f} ms (median of 3 after warm-up), "
        f"dense-equivalent tokens/s tree {n_dense_tokens / tree_ms * 1e3:.1f}, dense "
        f"{n_dense_tokens / dense_ms * 1e3:.1f}, speedup {dense_ms / tree_ms:.3f}; "
        f"max_memory_allocated {peak_gib:.3f} GiB; padded trie length {n}; tree with the "
        f"online softmax (no per-layer host read of max(C)) {online_ms:.2f} ms")
    profile_forward(lambda: engine.forward(params, tree_batch), "tree forward")
    profile_forward(lambda: engine.forward(params, dense_batch), "dense forward")

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
        })
    for kd in kernels:
        log(f"{kd['id']} {kd['name']}: {kd['ms']:.3f} ms (bound {kd['bound_ms']:.3f} ms by "
            f"{kd['bound_by']}, plain {kd['plain_ms']:.2f} ms, library {kd['library_ms']:.3f} ms), "
            f"{kd['launches']} launches on the main path")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
