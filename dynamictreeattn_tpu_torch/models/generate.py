"""Autoregressive sampling with a KV cache — the rollout side of the RL loop.

Counterpart of ``dynamictreeattn_tpu/models/generate.py`` (dense and MoE families):
batched prefill + decode, greedy or temperature sampling with top-k / top-p /
min-p filters (``ops/sampling.py``), flat (``generate``) and grouped
(``generate_grouped``: G completions per prompt against one shared prompt
cache, the rollout-side mirror of the tree engine's prefix sharing).

Every layer runs the model's own ``_layer`` (``models/qwen3.py``: unfused
qk-norm and RoPE, SwiGLU) with the attention of its step injected, so the
JAX module's ``_grouped_qkv`` / ``_grouped_ffn`` are ``attention_inputs`` and
the tail of ``_layer``. The attentions:

* prefill (``_layer_step``): plain masked matmul attention of T new tokens of
  one sequence over its cache (no Pallas kernel exists here in JAX);
* flat decode (``_layer_step_decode``): each row's prompt columns < plen and
  completion columns [lp0, lp0 + t), plus the self column;
* grouped decode (``_layer_step_grouped``): backend ``"kernel"`` runs K13
  (``ops/decode_attention.py``; on CPU tensors its plain version),
  ``"reference"`` the JAX module's einsum formulation (its ``"xla"``
  backend). Products of low-precision operands accumulate in fp32, the JAX
  module's ``preferred_element_type=float32`` (``_matmul_f32``).

Differences from the JAX module:

* the caches are updated in place (the functions still return them);
* ``key`` becomes ``generator`` (a ``torch.Generator`` on the params'
  device; None = seeded 0), so sampled tokens are not JAX's tokens;
* ``backend`` is ``"auto" | "kernel" | "reference"``, and ``"auto"`` is the
  kernel: the JAX rule (auto = its einsum path) was a TPU measurement;
* the JAX module compiles the whole grouped rollout (a ``lax.scan``, or a
  ``lax.while_loop`` under eos). Here, on CUDA tensors with the kernel
  backend, the grouped decode step is captured once as a CUDA graph over
  static buffers — the step t lives on the device, as K13's scalar-prefetched
  t does on the TPU — and replayed once per token (``_decode_loop_grouped``);
  the flat sampler and the reference backend slice by a host t and stay
  eager Python loops. Every decode step reads only the branch-cache columns
  < t, so the JAX module's windowed branch caches do not exist. With
  ``eos_id`` the loop stops once every row has sampled eos, checked (a host
  read) every ``EOS_CHECK_EVERY`` steps — the forced-eos tail makes the
  output the same;
* a rollout of ``max_new`` tokens runs ``max_new - 1`` decode steps: the
  prefill's logits give the first token, and the JAX scan's last step
  computes logits that it discards;
* the prefill runs each row's real tokens only (the JAX prefill runs the
  padding too and masks it out later).

MoE layers (``models/qwen3.py`` ``_moe_block``) route with a capacity that
is a host integer from shapes, chosen so that the port drops the (token,
choice) pairs that the JAX module drops:

* prefill: JAX routes each row over the padded prompt width Lp, padding
  masked by `valid`; the port runs the row's real tokens with the capacity
  of Lp rows (padding sorts behind every expert's real pairs, so the kept
  set is the same). ``generate_grouped`` takes Lp as given, as the JAX
  module's einsum backend does (its Pallas backend first pads Lp to a
  multiple of 512, and so routes with another capacity);
* flat decode: JAX routes each row alone (T = 1), where nothing drops; the
  port routes the B rows together with capacity B, where nothing drops
  either (an expert receives at most one pair of each row);
* grouped decode: capacity P·G for the P·G rows, exact in the same way (JAX:
  G per prompt).

Everything runs on the params' device; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamictreeattn_tpu_torch.models.qwen3 import (
    Qwen3Config,
    _layer,
    lm_head_weight,
    moe_capacity,
    rms_norm,
    rope_tables,
)
from dynamictreeattn_tpu_torch.ops import _build
from dynamictreeattn_tpu_torch.ops.decode_attention import decode_attention_grouped
from dynamictreeattn_tpu_torch.ops.sampling import categorical, filter_logits
from dynamictreeattn_tpu_torch.utils.profiling import span

__all__ = ["forward_hidden_cached", "forward_step", "generate", "generate_grouped", "init_cache"]

NEG = -1e30
EOS_CHECK_EVERY = 8
BACKENDS = ("auto", "kernel", "reference")
# the grouped decode loop's side stream, one a device: PyTorch keeps a cuBLAS
# workspace for every stream a product runs on and never frees it, so a
# stream made for every call left 32 MiB more allocated after each rollout
# on an H100
_SIDE_STREAMS: dict = {}


def init_cache(config: Qwen3Config, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """{'k','v'}: [L, B, Hkv, max_len, dh] zero-initialized cache."""
    c = config
    shape = (c.num_hidden_layers, batch, c.num_key_value_heads, max_len, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 a @ b of 2-D or 3-D (batched) operands, summed in fp32 (JAX
    ``preferred_element_type=float32``). On CUDA, low-precision operands go
    to cuBLAS with an fp32 output (``out_dtype``): no fp32 copy of either
    operand — for the LM head that copy would be the 311 MB Qwen3 embedding
    every step. Elsewhere they are cast to fp32, whose products of bf16
    values are exact: the same sum."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _layer_list(params: dict) -> list[dict]:
    """Per-layer dicts of views of the stacked [L, ...] weights."""
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    return [{name: w[i] for name, w in layers.items()} for i in range(len(params["layers"]["wq"]))]


def _logits(params: dict, config: Qwen3Config, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 [..., V] logits of final-norm'd hidden states [..., d]."""
    flat = hidden.reshape(-1, hidden.shape[-1])
    return _matmul_f32(flat, lm_head_weight(params, config)).reshape(*hidden.shape[:-1], -1)


# -------------------------------------------------------------------- prefill


def _layer_step(x, lp, cos, sin, ck, cv, start: int, config: Qwen3Config, valid=None,
                capacity: int | None = None):
    """One layer over T new tokens of ONE sequence against its cache. x
    [T, d]; ck/cv [Hkv, Lmax, dh], written in place at slots [start,
    start + T). `valid` / `capacity`: the MoE block's (``_moe_block``).
    Returns (x, ck, cv)."""
    T = x.shape[0]
    S = start + T

    def attn(q, k, v):  # [hq, T, dh], [hkv, T, dh]
        ck[:, start:S] = k
        cv[:, start:S] = v
        hq, _, dh = q.shape
        hkv = k.shape[0]
        qh = q.reshape(hkv, hq // hkv * T, dh).to(ck.dtype)  # rows (group head, token)
        st = _matmul_f32(qh, ck[:, :S].transpose(1, 2)) * dh**-0.5
        st = st.reshape(hkv, hq // hkv, T, S)
        col = torch.arange(S, device=x.device)
        row = start + torch.arange(T, device=x.device)
        st = st.masked_fill(col[None, :] > row[:, None], NEG)
        p = torch.softmax(st, dim=-1).to(cv.dtype)
        o = _matmul_f32(p.reshape(hkv, -1, S), cv[:, :S])
        return o.reshape(hq, T, dh).to(x.dtype)

    return _layer(x, lp, cos, sin, config, attn, valid=valid, capacity=capacity)[0], ck, cv


def forward_hidden_cached(params: dict, config: Qwen3Config, tokens: torch.Tensor,
                          positions: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                          start: int, valid=None, moe_rows: int | None = None):
    """T tokens of one sequence through all layers, the cache written in
    place — WITHOUT the LM head. tokens/positions [T]; cache_k/v
    [L, Hkv, Lmax, dh]; returns (hidden [T, d] post-final-norm, cache_k,
    cache_v). `valid` ([T], nonzero = real) keeps padding out of MoE
    routing, as in the JAX module; a MoE layer's capacity is that of
    `moe_rows` routed rows (default T: the prefill passes the padded prompt
    width when it runs a row's real tokens only)."""
    c = config
    x = params["embed"].index_select(0, tokens.long())
    cos, sin = rope_tables(positions, c.head_dim, c.rope_theta, c.rope_scaling_tuple)
    capacity = moe_capacity(c, x.shape[0] if moe_rows is None else moe_rows) if c.is_moe else None
    for i, lp in enumerate(_layer_list(params)):
        x, _, _ = _layer_step(x, lp, cos, sin, cache_k[i], cache_v[i], int(start), c, valid, capacity)
    return rms_norm(x, params["final_norm"], c.rms_norm_eps), cache_k, cache_v


def forward_step(params: dict, config: Qwen3Config, tokens, positions, cache_k, cache_v,
                 start: int, valid=None):
    """``forward_hidden_cached`` + the LM head: (logits [T, V] fp32, cache_k,
    cache_v)."""
    hidden, ck, cv = forward_hidden_cached(params, config, tokens, positions, cache_k, cache_v,
                                           start, valid)
    return _logits(params, config, hidden), ck, cv


def _prefill(params, config, prompts: np.ndarray, lens: np.ndarray, cache_k, cache_v):
    """Each row's real tokens into its cache row [L, B, ...]; returns fp32
    logits [B, V] of each row's last prompt token (the LM head runs on those
    rows only). A MoE layer routes each row with the capacity of the padded
    width Lp, as the JAX prefill does."""
    dev = cache_k.device
    tok = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    last = []
    for b, n in enumerate(lens.tolist()):
        hidden, _, _ = forward_hidden_cached(params, config, tok[b, :n], torch.arange(n, device=dev),
                                             cache_k[:, b], cache_v[:, b], 0, moe_rows=prompts.shape[1])
        last.append(hidden[n - 1])
    return _logits(params, config, torch.stack(last))


# ---------------------------------------------------------------- flat decode


def _layer_step_decode(x, lp, cos, sin, ck, cv, plens, lp0: int, t: int, config: Qwen3Config):
    """One layer, one decode token of each of B rows, cache READ-ONLY. x
    [B, d]; ck/cv [B, Hkv, Lmax, dh]: row b's prompt in slots [0, plen_b),
    its completion in [lp0, lp0 + t). The current token enters through an
    explicit self column. Returns (x, k [B, Hkv, dh], v) for the caller to
    write at slot lp0 + t."""
    kv = []

    def attn(q, k, v):  # [hq, B, dh], [hkv, B, dh]
        hq, B, dh = q.shape
        hkv = k.shape[0]
        grp = hq // hkv
        S = lp0 + t
        scale = dh**-0.5
        kv.append((k.transpose(0, 1), v.transpose(0, 1)))
        qh = q.transpose(0, 1).reshape(B * hkv, grp, dh).to(ck.dtype)
        st = _matmul_f32(qh, ck[:, :, :S].reshape(B * hkv, S, dh).transpose(1, 2)) * scale
        col = torch.arange(S, device=x.device)
        visible = (col[None, :] < plens[:, None]) | (col[None, :] >= lp0)  # [B, S]
        st = st.reshape(B, hkv, grp, S).masked_fill(~visible[:, None, None, :], NEG)
        qf = qh.float().reshape(B, hkv, grp, dh)
        st_s = torch.sum(qf * k.transpose(0, 1).float()[:, :, None, :], dim=-1) * scale
        # two-piece softmax merge (cache / self)
        m = torch.maximum(st.amax(-1), st_s)  # [B, hkv, grp]
        pc = torch.exp(st - m[..., None])
        ps = torch.exp(st_s - m)
        l = pc.sum(-1) + ps
        o = _matmul_f32(pc.to(cv.dtype).reshape(B * hkv, grp, S),
                        cv[:, :, :S].reshape(B * hkv, S, dh)).reshape(B, hkv, grp, dh)
        o = o + ps[..., None] * v.transpose(0, 1).float()[:, :, None, :]
        o = (o / l[..., None]).reshape(B, hq, dh).to(x.dtype)
        return o.transpose(0, 1)

    x = _layer(x, lp, cos, sin, config, attn, capacity=x.shape[0])[0]  # MoE: exact at B
    return (x, *kv[0])


def _decode_step_flat(params, c: Qwen3Config, tok, plens, lp0: int, t: int, ck, cv, *,
                      layers=None):
    """One decode token for all [B] rows. tok/plens [B]; ck/cv
    [L, B, Hkv, Lmax, dh], the new k/v written at the common slot lp0 + t
    after the layer loop. Returns (logits [B, V] fp32, ck, cv). `layers`:
    ``_layer_list(params)``, when the caller keeps it across steps."""
    x = params["embed"].index_select(0, tok.long())
    cos, sin = rope_tables(plens + t, c.head_dim, c.rope_theta, c.rope_scaling_tuple)
    ks, vs = [], []
    for i, lp in enumerate(layers or _layer_list(params)):
        x, k, v = _layer_step_decode(x, lp, cos, sin, ck[i], cv[i], plens, lp0, t, c)
        ks.append(k)
        vs.append(v)
    ck[:, :, :, lp0 + t] = torch.stack(ks)
    cv[:, :, :, lp0 + t] = torch.stack(vs)
    hidden = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return _logits(params, c, hidden), ck, cv


# ------------------------------------------------------------- grouped decode


def _grouped_attention_reference(q, k, v, kp, vp, kc, vc, plens, t: int):
    """The JAX module's grouped-decode attention (its "xla" backend), batched
    over prompts: q [P, G, hq, dh], k/v [P, G, hkv, dh] of the current token;
    kp/vp [P, hkv, Lp, dh] (columns < plen visible); kc/vc
    [P, G, hkv, Nc, dh] (columns < t read). Three-piece softmax merge
    (prompt / own completion / self). Returns fp32 o [P, G, hq, dh]."""
    P, G, hq, dh = q.shape
    hkv, Lp = kp.shape[1], kp.shape[2]
    grp = hq // hkv
    scale = dh**-0.5
    qh = q.reshape(P, G, hkv, grp, dh).to(kp.dtype)
    # shared prompt: one product per (prompt, kv head) over all G*grp rows
    qp = qh.permute(0, 2, 1, 3, 4).reshape(P * hkv, G * grp, dh)
    st_p = _matmul_f32(qp, kp.reshape(P * hkv, Lp, dh).transpose(1, 2)) * scale
    st_p = st_p.reshape(P, hkv, G, grp, Lp).transpose(1, 2)  # [P, G, hkv, grp, Lp]
    st_p = st_p.masked_fill(torch.arange(Lp, device=q.device) >= plens[:, None, None, None, None], NEG)
    st_s = torch.sum(qh.float() * k.to(qh.dtype).float()[:, :, :, None, :], dim=-1) * scale
    m = torch.maximum(st_p.amax(-1), st_s)  # [P, G, hkv, grp]
    if t:
        st_c = _matmul_f32(qh.reshape(P * G * hkv, grp, dh),
                           kc[:, :, :, :t].reshape(P * G * hkv, t, dh).transpose(1, 2)) * scale
        st_c = st_c.reshape(P, G, hkv, grp, t)
        m = torch.maximum(m, st_c.amax(-1))
    pp = torch.exp(st_p - m[..., None])
    ps = torch.exp(st_s - m)
    l = pp.sum(-1) + ps
    o = _matmul_f32(pp.transpose(1, 2).to(vp.dtype).reshape(P * hkv, G * grp, Lp),
                    vp.reshape(P * hkv, Lp, dh)).reshape(P, hkv, G, grp, dh).transpose(1, 2)
    o = o + ps[..., None] * v.float()[:, :, :, None, :]
    if t:
        pc = torch.exp(st_c - m[..., None])
        l = l + pc.sum(-1)
        o = o + _matmul_f32(pc.to(vc.dtype).reshape(P * G * hkv, grp, t),
                            vc[:, :, :, :t].reshape(P * G * hkv, t, dh)).reshape(P, G, hkv, grp, dh)
    return (o / l[..., None]).reshape(P, G, hq, dh)


def _layer_step_grouped(x, lp, cos, sin, ckp, cvp, ckc, cvc, t, plens, config: Qwen3Config,
                        backend: str = "kernel"):
    """One layer, one decode token for each of G branches of P prompts. x
    [P*G, d] (prompt-major rows); cos/sin [P*G, dh]; ckp/cvp [P, Hkv, Lp, dh]
    frozen shared prompt cache; ckc/cvc [P, G, Hkv, Nc, dh] per-branch
    completion caches, READ-ONLY here (columns < t live). Branches attend to
    their prompt's columns < plen, their own completion columns < t and
    themselves, never to each other. t: an int, or (backend "kernel") one
    int32 on the device. Returns (x, k [P, G, Hkv, dh], v) for the caller to
    write at slot t."""
    P, G = ckc.shape[:2]
    kv = []

    def attn(q, k, v):  # [hq, P*G, dh], [hkv, P*G, dh]
        hq, n, dh = q.shape
        qg = q.transpose(0, 1).reshape(P, G, hq, dh)
        kg = k.transpose(0, 1).reshape(P, G, -1, dh)
        vg = v.transpose(0, 1).reshape(P, G, -1, dh)
        kv.append((kg, vg))
        if backend == "kernel":
            dt = ckp.dtype
            o = decode_attention_grouped(qg.to(dt), kg.to(dt), vg.to(dt), ckp, cvp, ckc, cvc, plens, t)
        else:
            o = _grouped_attention_reference(qg, kg, vg, ckp, cvp, ckc, cvc, plens, int(t))
        return o.to(x.dtype).reshape(n, hq, dh).transpose(0, 1)

    x = _layer(x, lp, cos, sin, config, attn, capacity=x.shape[0])[0]  # MoE: exact at P*G
    return (x, *kv[0])


def _write_slot(cache, t, val) -> None:
    """cache [L, P, G, Hkv, Nc, dh][:, :, :, :, t] = val [L, P, G, Hkv, dh];
    a tensor t is written at its device index, with no host read."""
    if isinstance(t, torch.Tensor):
        cache.index_copy_(4, t.reshape(1).long(), val.unsqueeze(4).to(cache.dtype))
    else:
        cache[:, :, :, :, t] = val


def _decode_step_grouped(params, c: Qwen3Config, tok, plens, t, ckp, cvp, ckc, cvc,
                         backend: str = "kernel", *, layers=None):
    """One decode token for all [P, G] branches. tok [P, G]; plens int32
    [P]; t the step, an int or one int32 on the device; ckp/cvp
    [L, P, Hkv, Lp, dh] frozen; ckc/cvc [L, P, G, Hkv, Nc, dh], written at
    slot t after the layer loop. backend "kernel": each layer's attention is
    one K13 call over all (prompt, branch) pairs, which reads a tensor t on
    the device (so the step can be captured as a CUDA graph); "reference":
    the plain einsum formulation, which slices by a host t (one host read of
    a tensor t). Returns (logits [P, G, V] fp32, ckc, cvc). `layers`:
    ``_layer_list(params)``, when the caller keeps it."""
    if backend != "kernel" and isinstance(t, torch.Tensor):
        t = int(t)
    P, G = tok.shape
    x = params["embed"].index_select(0, tok.reshape(-1).long())  # [P*G, d]
    cos, sin = rope_tables(plens + t, c.head_dim, c.rope_theta, c.rope_scaling_tuple)  # [P, dh]
    cos, sin = cos.repeat_interleave(G, dim=0), sin.repeat_interleave(G, dim=0)
    ks, vs = [], []
    for i, lp in enumerate(layers or _layer_list(params)):
        x, k, v = _layer_step_grouped(x, lp, cos, sin, ckp[i], cvp[i], ckc[i], cvc[i], t, plens, c,
                                      backend)
        ks.append(k)
        vs.append(v)
    _write_slot(ckc, t, torch.stack(ks))
    _write_slot(cvc, t, torch.stack(vs))
    hidden = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return _logits(params, c, hidden).reshape(P, G, -1), ckc, cvc


# ------------------------------------------------------------------ samplers


def _sampler(generator, temperature, greedy, top_k, top_p, min_p):
    """logits [..., V] fp32 -> int64 tokens [...]."""

    def sample(logits):
        if greedy:
            return torch.argmax(logits, dim=-1)
        lg = logits / temperature
        if top_k or top_p is not None or min_p is not None:
            lg = filter_logits(lg, top_k, top_p, min_p)
        return categorical(lg, generator)

    return sample


def _decode_loop(step, sample, tok, max_new: int, eos_id):
    """The flat sampler's loop, with a host t. [max_new, *tok.shape] int32:
    tok, then each sampled token of ``sample(step(tok, t))``. With `eos_id`,
    a row's tokens after its first eos are eos, and the loop stops once
    every row is done (checked every EOS_CHECK_EVERY steps: one host read)."""
    fill = 0 if eos_id is None else int(eos_id)
    out = torch.full((max_new, *tok.shape), fill, dtype=torch.int32, device=tok.device)
    done = torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
    for t in range(max_new):
        out[t] = tok
        if t + 1 == max_new:
            break
        nxt = sample(step(tok, t))
        if eos_id is not None:
            done = done | (tok == fill)
            if (t + 1) % EOS_CHECK_EVERY == 0 and bool(done.all()):
                break
            nxt = nxt.masked_fill(done, fill)
        tok = nxt
    return out


def _grouped_state(tok0, max_new: int, eos_id) -> dict:
    """The grouped loop's static buffers: tok [P, G] int32 (the current
    token), t int32 [] (its step), done [P, G] (rows past their eos), out
    [max_new, P, G] int32 (eos-filled under `eos_id`)."""
    dev = tok0.device
    fill = 0 if eos_id is None else int(eos_id)
    return {"tok": tok0.to(torch.int32), "t": torch.zeros((), dtype=torch.int32, device=dev),
            "done": torch.zeros(tok0.shape, dtype=torch.bool, device=dev),
            "out": torch.full((max_new, *tok0.shape), fill, dtype=torch.int32, device=dev)}


def _grouped_step(step, sample, state: dict, eos_id) -> None:
    """One decode step over `state`, in place: out[t] = tok; tok = the token
    sampled from ``step(tok, t)`` (eos once a row has sampled eos); t += 1.
    A function of the buffers alone: the CUDA graph captures it, and on the
    CPU the loop calls it."""
    tok, t = state["tok"], state["t"]
    state["out"].index_copy_(0, t.reshape(1).long(), tok[None])
    nxt = sample(step(tok, t))
    if eos_id is not None:
        state["done"].logical_or_(tok == eos_id)
        nxt = nxt.masked_fill(state["done"], eos_id)
    tok.copy_(nxt)
    t.add_(1)


def _use_graph(device: torch.device, backend: str) -> bool:
    """Whether the grouped loop replays a captured step: on CUDA with the
    kernel backend (the reference backend slices by a host t)."""
    return device.type == "cuda" and backend == "kernel"


def _captured_step(run, stream, generator):
    """A replay function of `run` (one ``_grouped_step``, already run once
    on `stream` to warm up the allocator, cuBLAS and the kernels), captured
    as a CUDA graph on `stream`. `generator` (None when nothing is drawn) is
    registered with the graph, so each replay advances it as an eager step
    would. Each replay adds the capture's launch counts."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with _build.captured_launches() as counts, torch.cuda.graph(graph, stream=stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)

    def replay():
        graph.replay()
        _build.add_launches(counts)

    return replay


def _decode_loop_grouped(run, state: dict, max_new: int, eos_id, generator, graph: bool):
    """Runs `run` (one ``_grouped_step`` over `state`) for the max_new - 1
    decode steps; returns out [max_new, P, G]. With `graph` (CUDA) the first
    step runs eagerly on the device's side stream (kept across calls in
    ``_SIDE_STREAMS``), the second is captured there, and
    every step from it on is a replay (max_new - 2 replays); a failed
    capture raises. With `eos_id` the loop stops once every row is done,
    checked every EOS_CHECK_EVERY steps (one host read). Host spans:
    "generate.capture" (the eager first step and the capture),
    "generate.decode" (the other steps)."""
    side = replay = None
    first = 0
    if graph and max_new > 1:
        side = _SIDE_STREAMS.get(state["t"].device)
        if side is None:
            side = _SIDE_STREAMS[state["t"].device] = torch.cuda.Stream(device=state["t"].device)
        side.wait_stream(torch.cuda.current_stream())
        with span("generate.capture"):
            with torch.cuda.stream(side):
                run()
            if max_new > 2:
                replay = _captured_step(run, side, generator)
        first = 1  # EOS_CHECK_EVERY > 1: no check falls after the first step
    with span("generate.decode"):
        for i in range(first, max_new - 1):
            (replay or run)()
            if eos_id is not None and (i + 1) % EOS_CHECK_EVERY == 0 and bool(state["done"].all()):
                break
    if side is not None:
        torch.cuda.current_stream().wait_stream(side)
    state["out"].index_copy_(0, state["t"].reshape(1).long(), state["tok"][None])
    return state["out"]


def _host_prompts(prompts, prompt_lens):
    prompts = np.asarray(prompts, dtype=np.int32)
    lens = np.asarray(prompt_lens, dtype=np.int32)
    if prompts.ndim != 2 or lens.shape != prompts.shape[:1]:
        raise ValueError(f"prompts [B, Lp] and prompt_lens [B], got {prompts.shape} and {lens.shape}")
    if lens.size and (lens.min() < 1 or lens.max() > prompts.shape[1]):
        raise ValueError(f"prompt_lens must lie in [1, {prompts.shape[1]}]")
    return prompts, lens


def generate(params: dict, config: Qwen3Config, prompts, prompt_lens, max_new: int,
             generator: torch.Generator | None = None, temperature: float = 1.0,
             greedy: bool = False, eos_id: int | None = None, top_k: int = 0,
             top_p: float | None = None, min_p: float | None = None) -> np.ndarray:
    """Sample `max_new` continuation tokens for each right-padded prompt row.

    prompts [B, Lp] int32, prompt_lens [B] — returns numpy int32
    [B, max_new] (compose full sequences as prompt[:len] + row). With
    `eos_id`, every token after a sampled eos is eos (truncate host-side).
    `top_k`/`top_p`/`min_p` filter logits after temperature with HF-warper
    semantics (ops/sampling.py). `generator` (on the params' device; None =
    seeded 0) draws the samples. A latent-attention (MLA) config raises
    NotImplementedError: it needs a latent decode cache."""
    c = config
    _no_mla(c)
    prompts, lens = _host_prompts(prompts, prompt_lens)
    B, Lp = prompts.shape
    dev = params["embed"].device
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    sample = _sampler(gen, temperature, greedy, top_k, top_p, min_p)
    with torch.inference_mode():
        cache = init_cache(c, B, Lp + max_new, params["layers"]["wq"].dtype, dev)
        last = _prefill(params, c, prompts, lens, cache["k"], cache["v"])  # [B, V]
        plens = torch.as_tensor(lens, device=dev)
        layers = _layer_list(params)

        def step(tok, t):
            return _decode_step_flat(params, c, tok, plens, Lp, t, cache["k"], cache["v"],
                                     layers=layers)[0]

        toks = _decode_loop(step, sample, sample(last), int(max_new), eos_id)
    return toks.T.cpu().numpy()


def _no_mla(config: Qwen3Config) -> None:
    if config.is_mla:
        raise NotImplementedError("sampling a latent-attention (DeepSeek-V3 / MLA) model needs a latent decode "
                                  "cache and a grouped-decode kernel (K13) at the latent width: not ported")


def generate_grouped(params: dict, config: Qwen3Config, prompts, prompt_lens, group: int,
                     max_new: int, generator: torch.Generator | None = None,
                     temperature: float = 1.0, greedy: bool = False, eos_id: int | None = None,
                     backend: str = "auto", top_k: int = 0, top_p: float | None = None,
                     min_p: float | None = None) -> np.ndarray:
    """Sample `group` completions per prompt with a SHARED prompt KV cache.

    prompts [P, Lp] int32 (right-padded), prompt_lens [P] — returns numpy
    int32 [P, group, max_new]. Each prompt is prefilled once; its `group`
    branches decode against the frozen shared prompt cache plus their own
    completion caches. Greedy, it is token for token ``generate`` on the
    G-times-duplicated prompt batch, at 1/G of the prefill compute and
    prompt-cache memory. `eos_id`, filters and `generator` as in
    ``generate``.

    backend: "auto" (= "kernel") | "kernel" (each layer's attention is one
    K13 call: the CUDA kernel on CUDA tensors, its plain version on CPU
    tensors) | "reference" (the plain einsum formulation).

    On CUDA with the kernel backend the decode step (embed, every layer, LM
    head, sampling, the cache and token writes, t += 1) is captured once as
    a CUDA graph and replayed; its transients live in the graph's pool until
    the call returns. A latent-attention (MLA) config raises
    NotImplementedError, as in ``generate``."""
    c = config
    _no_mla(c)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    backend = "kernel" if backend == "auto" else backend
    prompts, lens = _host_prompts(prompts, prompt_lens)
    P, Lp = prompts.shape
    G = int(group)
    dev = params["embed"].device
    dtype = params["layers"]["wq"].dtype
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    sample = _sampler(gen, temperature, greedy, top_k, top_p, min_p)
    with torch.inference_mode():
        with span("generate.prefill"):
            cache = init_cache(c, P, Lp, dtype, dev)  # the prompt cache, prefilled once
            last = _prefill(params, c, prompts, lens, cache["k"], cache["v"])  # [P, V]
        shape = (c.num_hidden_layers, P, G, c.num_key_value_heads, int(max_new), c.head_dim)
        ckc = torch.zeros(shape, dtype=dtype, device=dev)
        cvc = torch.zeros(shape, dtype=dtype, device=dev)
        plens = torch.as_tensor(lens, device=dev)
        layers = _layer_list(params)

        def step(tok, t):
            return _decode_step_grouped(params, c, tok, plens, t, cache["k"], cache["v"], ckc, cvc,
                                        backend, layers=layers)[0]

        state = _grouped_state(sample(last[:, None, :].expand(P, G, last.shape[-1])), int(max_new),
                               eos_id)

        def run():
            _grouped_step(step, sample, state, eos_id)

        toks = _decode_loop_grouped(run, state, int(max_new), eos_id, None if greedy else gen,
                                    _use_graph(dev, backend))
    with span("generate.read"):
        return toks.permute(1, 2, 0).cpu().numpy()
