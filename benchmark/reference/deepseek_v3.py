"""The plain reference of the DeepSeek-V3 block (Moonlight-16B-A3B) in
float32 PyTorch: forward, loss, gradients and the optimizer's steps.

Nothing here comes from the program: no kernel, no trie, no weights it
made. Layers follow ``modeling_deepseek.py`` (``DeepseekV3DecoderLayer``)
with ``q_lora_rank: null``: RMSNorm; MLA (q = h Wq split into a no-RoPE and
a RoPE part per head; [c, k_pe] = h Wkv_a, c RMSNorm'd, [k_nope, v] = c
Wkv_b per head; the published interleaved RoPE (``apply_rotary_pos_emb``)
on q_pe and on the one k_pe every head shares; causal softmax attention of
[q_nope, q_pe] . [k_nope, k_pe] at scale (nope + rope) ** -0.5 over v; o
Wo); residual; RMSNorm; a SwiGLU MLP (the first ``first_k_dense_replace``
layers) or the MoE block (``MoEGate`` at ``scoring_func: sigmoid``,
``topk_method: noaux_tc`` with one group: top-k of sigmoid(logits) +
e_score_correction_bias, weights the chosen sigmoids renormalised over
their sum + 1e-20 and times ``routed_scaling_factor``; SwiGLU experts; plus
the shared experts, one SwiGLU of width n_shared_experts x
moe_intermediate_size); residual; the final RMSNorm and the untied head.

Departures from ``modeling_deepseek.py``, each also the program's:

* the capacity dispatch (``assumed``): each expert keeps the first
  ceil(factor * n_pad * k / E) (row, choice) pairs of a step, in the trie's
  row order, sorted stably by expert (n_pad the trie's tokens padded to a
  multiple of 128, as the program routes them); the rest are dropped. The
  published model routes without a capacity. The layers therefore run over
  the batch's sequences together, layer by layer, as ``model.py``'s MoE
  batch does;
* the routed experts' outputs summed in float32 per row; the MoE block and
  the leading dense MLP, both row-wise, run once per trie token (the first
  copy of each) and their output is handed to every copy;
* RoPE's cos and sin in float32 (HF caches them in the model's dtype);
* e_score_correction_bias drawn from the seed (``weights`` here), not a
  trained bias;
* the loss is the port's linear weighted loss (``model.py``), with no
  auxiliary term (the model balances without one).

Matrix products go through ``model.py``'s precisions (float32 with TF32 off,
or the fp8 control). The training steps: ``model.py``'s AdamW (float32
moments in host memory, the parameters rounded to bfloat16 after each
update) over every leaf but the buffers (the bias), which stay as drawn.

The routing can be forced (``train_steps``'s `forced`): each MoE layer then
sends the trie's rows to the experts another side chose there, weighted by
this side's own sigmoids, and reports how far those choices lie below its
own top-k (``route_gap``). A bf16 program's router flips choices whose
selection values lie within its rounding of each other; each flip sends a
row through other experts and moves two experts' capacity ranks, so its
gradients part from an unforced float32 reference's by more than rounding.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference import model as ref

BUFFERS = "buffers"  # the params' key of what is not trained
MLP_ROWS = 4096  # rows of the dense MLP's [rows, intermediate] float32 activations formed at once
BIAS_STD = 0.1  # the routing bias's spread (assumed): half the sigmoid scores' (about 0.21 at N(0, 1) logits)


# ---------------------------------------------------------------- weights


def dims(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    Ld = cfg["first_k_dense_replace"]
    return dict(d=d, H=H, r=cfg["kv_lora_rank"], dn=cfg["qk_nope_head_dim"], dr=cfg["qk_rope_head_dim"],
                dv=cfg["v_head_dim"], V=cfg["vocab_size"], I=cfg["intermediate_size"], E=cfg["n_routed_experts"],
                k=cfg["num_experts_per_tok"], Ie=cfg["moe_intermediate_size"],
                Is=cfg["n_shared_experts"] * cfg["moe_intermediate_size"], Ld=Ld, Lm=cfg["num_hidden_layers"] - Ld)


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple, object]]:
    """[(path, shape, fan_in, None for a norm weight, or "bias")] in the
    port's leaf order (``models/deepseek_v3.py``); the head as its [V, d]
    storage."""
    m = dims(cfg)
    d, H, r, dn, dr, dv = m["d"], m["H"], m["r"], m["dn"], m["dr"], m["dv"]

    def attention(L):
        return [("ln1", (L, d), None), ("ln2", (L, d), None), ("wq", (L, d, H * (dn + dr)), d),
                ("wkv_a", (L, d, r + dr), d), ("kv_norm", (L, r), None), ("wkv_b", (L, r, H * (dn + dv)), r),
                ("wo", (L, H * dv, d), H * dv)]

    Ld, Lm, E, Ie, Is, I = m["Ld"], m["Lm"], m["E"], m["Ie"], m["Is"], m["I"]
    dense = attention(Ld) + [("gate", (Ld, d, I), d), ("up", (Ld, d, I), d), ("down", (Ld, I, d), I)]
    moe = attention(Lm) + [("router", (Lm, d, E), d), ("e_gate", (Lm, E, d, Ie), d), ("e_up", (Lm, E, d, Ie), d),
                           ("e_down", (Lm, E, Ie, d), Ie), ("s_gate", (Lm, d, Is), d), ("s_up", (Lm, d, Is), d),
                           ("s_down", (Lm, Is, d), Is)]
    return ([(("embed",), (m["V"], d), d)] + [(("dense_layers", n), s, f) for n, s, f in dense]
            + [(("layers", n), s, f) for n, s, f in moe]
            + [(("final_norm",), (d,), None), (("lm_head",), (m["V"], d), d), ((BUFFERS, "e_bias"), (Lm, E), "bias")])


def _leaf_seed(seed: int, path: tuple) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{'.'.join(path)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_leaf(cfg: dict, seed: int, path: tuple, device, dtype=torch.bfloat16) -> torch.Tensor:
    """One leaf as ``make_weights`` draws it: projections N(0, 1/fan_in) in
    `dtype`, norm weights 1, the routing bias N(0, BIAS_STD^2) in float32;
    the head as its [d, V] view. A stack is drawn a matrix at a time."""
    for p, shape, fan_in in leaf_specs(cfg):
        if p == path:
            break
    else:
        raise KeyError(path)
    if fan_in is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    if fan_in == "bias":
        return torch.empty(shape, dtype=torch.float32, device=device).normal_(0.0, BIAS_STD, generator=gen)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in out.reshape(-1, *shape[-2:]):
        part.normal_(0.0, fan_in ** -0.5, generator=gen)
    return out.t() if path == ("lm_head",) else out


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole model's weights in the port's nested layout, buffers included."""
    params: dict = {}
    for path, _, _ in leaf_specs(cfg):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = make_leaf(cfg, seed, path, device, dtype)
    return params


def trained_leaves(params: dict) -> list[tuple[tuple, torch.Tensor]]:
    """[(path, tensor)] of the trained leaves in order (no buffers)."""
    return [(p, t) for p, t in ref.tree_leaves(params) if p[0] != BUFFERS]


# ---------------------------------------------------------------- forward


def rope_interleaved(x, cos, sin):
    """``apply_rotary_pos_emb`` of ``modeling_deepseek.py``: x [T, H, dr]
    de-interleaved (pairs (2i, 2i + 1) to i and dr/2 + i), then
    rotate-half RoPE; cos / sin [T, dr] (``model.rope_tables``)."""
    T, H, dr = x.shape
    x = x.view(T, H, dr // 2, 2).transpose(-1, -2).reshape(T, H, dr)
    return ref.rope(x, cos, sin)


def attention(q, k, v, mm):
    """Causal softmax attention, one k and v per head: q, k [T, H, dqk], v
    [T, H, dv] -> [T, H * dv], at scale dqk ** -0.5; queries in blocks of
    ``model.ATTN_ROWS`` against the keys up to their last row."""
    T, H, dqk = q.shape
    q, k, v = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
    out = []
    for r in range(0, T, ref.ATTN_ROWS):
        end = min(r + ref.ATTN_ROWS, T)
        s = mm(q[:, r:end], k[:, :end].transpose(1, 2)) * dqk ** -0.5
        causal = torch.ones(end - r, end, dtype=torch.bool, device=q.device).tril(r)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out.append(mm(p, v[:, :end]))
    return torch.cat(out, dim=1).transpose(0, 1).reshape(T, -1)


class Model:
    """The reference forward of a ``configs/*.json`` dict (HF's
    ``deepseek_v3`` keys); `params` a float32 tree in the port's layout, the
    stacks as lists of their layers' tensors."""

    def __init__(self, cfg: dict, precision: str = "fp32", route_log: list | None = None,
                 forced: list | None = None):
        self.cfg, self.m = cfg, dims(cfg)
        self.mm = ref.PRECISIONS[precision]
        self.route_log = route_log  # the first forward's routing, a dict a MoE layer, where given
        self.forced = forced  # [step][MoE layer] idx [rows, k] that the routing follows, where given
        self.step = 0  # the training step under way (``train_steps``)
        self.routes = {}  # (step, MoE layer): the idx [n, k] routed there, on the host
        self.route_gap = 0.0  # the largest selection deficit of a forced choice
        self.route_flips = [0, 0]  # forced (row, choice) pairs off this side's own top-k, of all pairs

    def attn_part(self, x, cos, sin, ln1, wq, wkv_a, kv_norm, wkv_b, wo):
        """x plus one sequence's MLA sublayer."""
        m, mm, eps = self.m, self.mm, self.cfg["rms_norm_eps"]
        T, H, dn, r = x.shape[0], m["H"], m["dn"], m["r"]
        h = ref.rms_norm(x, ln1, eps)
        q = mm(h, wq).reshape(T, H, dn + m["dr"])
        kv_a = mm(h, wkv_a)
        kv = mm(ref.rms_norm(kv_a[:, :r], kv_norm, eps), wkv_b).reshape(T, H, dn + m["dv"])
        q_pe = rope_interleaved(q[..., dn:], cos, sin)
        k_pe = rope_interleaved(kv_a[:, None, r:], cos, sin).expand(T, H, m["dr"])
        o = attention(torch.cat([q[..., :dn], q_pe], -1), torch.cat([kv[..., :dn], k_pe], -1), kv[..., dn:], mm)
        return x + mm(o, wo)

    def swiglu(self, h, gate, up, down):
        mm = self.mm
        return mm(F.silu(mm(h, gate)) * mm(h, up), down)

    def dense_mlp(self, hn, gate, up, down):
        """The SwiGLU MLP over rows hn, MLP_ROWS at a time (each recomputed
        in the backward)."""
        return torch.cat([checkpoint(self.swiglu, hn[r:r + MLP_ROWS], gate, up, down, use_reentrant=False)
                          for r in range(0, hn.shape[0], MLP_ROWS)])

    def moe_block(self, hn, router, bias, e_gate, e_up, e_down, s_gate, s_up, s_down, n_pad: int, at: int = 0):
        """The MoE block over the trie's tokens hn [n, d] in DFS order, with
        the configuration's capacity dispatch (module docstring): y [n, d].
        `at` is the MoE layer's index: where the routing is forced, its
        choices are the forced ones (``train_steps``)."""
        c, m, mm = self.cfg, self.m, self.mm
        n, d = hn.shape
        E, k = m["E"], m["k"]
        cap = math.ceil(c["assumed"]["moe_capacity_factor"] * n_pad * k / E)
        scores = torch.sigmoid(mm(hn, router))
        sel = (scores + bias).detach()
        top = torch.topk(sel, k, dim=-1)
        idx = top.indices
        forced = None if self.forced is None else self.forced[self.step][at][:n].to(hn.device, torch.long)
        if forced is not None and forced.shape != idx.shape:  # another trie: nothing to follow
            self.route_gap = math.inf
        elif forced is not None:
            if (self.step, at) not in self.routes:
                sound = bool((forced < E).all()) and not bool((forced.sort(-1).values.diff(dim=-1) == 0).any())
                deficit = (top.values[:, -1:] - sel.gather(1, forced.clamp(max=E - 1))).clamp(min=0)
                self.route_gap = max(self.route_gap, float(deficit.max()) if sound else math.inf)
                own = (forced[:, :, None] == idx[:, None, :]).any(-1)
                self.route_flips[0] += int((~own).sum())
                self.route_flips[1] += n * k
            idx = forced.clamp(max=E - 1)
        self.routes.setdefault((self.step, at), idx.detach().cpu())
        w = scores.gather(1, idx)
        if c["norm_topk_prob"]:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        w = w * c["routed_scaling_factor"]
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        start = torch.searchsorted(flat[order], torch.arange(E, device=hn.device))
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n * k, device=hn.device) - start[flat[order]]
        keep = rank < cap
        if self.route_log is not None and len(self.route_log) < m["Lm"]:
            plain = torch.topk(scores.detach(), k, dim=-1).indices
            moved = int((~(idx[:, :, None] == plain[:, None, :]).any(-1)).sum())
            self.route_log.append({"idx": idx.detach().cpu(), "dropped": int((~keep).sum()), "pairs": n * k,
                                   "bias_moved": moved})
        pair = order[keep[order]]  # the kept pairs, by expert
        rows = hn[pair // k]
        outs, at = [], 0
        for e, size in enumerate(torch.bincount(flat[pair], minlength=E).tolist()):
            if size:
                xe = rows[at:at + size]
                outs.append(self.swiglu(xe, e_gate[e], e_up[e], e_down[e]))
                at += size
        y = hn.new_zeros(n, d)
        if outs:
            y = y.index_add(0, pair // k, torch.cat(outs) * w.reshape(-1)[pair][:, None])
        return y + self.swiglu(hn, s_gate, s_up, s_down)

    def layer(self, x, cos, sin, bounds, first, node_of, n_pad, lw: dict, bias, at: int = 0):
        """One layer over the batch's concatenated sequences x [N, d]: MLA
        within each sequence (bounds; each recomputed alone in the
        backward), then the MLP or the MoE block (MoE layer `at`) over the
        trie's tokens (the first copy of each, `first`), its output handed
        to every copy (`node_of`)."""
        attn = [lw[n] for n in ("ln1", "wq", "wkv_a", "kv_norm", "wkv_b", "wo")]
        x = torch.cat([checkpoint(self.attn_part, x[a:b], cos[a:b], sin[a:b], *attn, use_reentrant=False)
                       for a, b in bounds])
        hn = ref.rms_norm(x[first], lw["ln2"], self.cfg["rms_norm_eps"])
        if bias is None:
            y = self.dense_mlp(hn, lw["gate"], lw["up"], lw["down"])
        else:
            y = self.moe_block(hn, lw["router"], bias, lw["e_gate"].unbind(0), lw["e_up"].unbind(0),
                               lw["e_down"].unbind(0), lw["s_gate"], lw["s_up"], lw["s_down"], n_pad, at)
        return x + y[node_of]

    def batch_loss(self, params: dict, seqs, attachs) -> torch.Tensor:
        """The linear weighted loss of a whole batch, summed over its
        sequences; the layers run over all sequences at once (the capacity
        dispatch couples them), each recomputed in the backward."""
        c, m = self.cfg, self.m
        dev = params["embed"].device
        node_of, n = ref.trie_rows(seqs)
        n_pad = -(-n // ref.PAD_ROWS) * ref.PAD_ROWS
        lens = [len(s) for s in seqs]
        ends = np.cumsum(lens)
        bounds = [(int(e - L), int(e)) for e, L in zip(ends, lens)]
        rows = torch.as_tensor(np.concatenate(node_of), device=dev)
        first = torch.full((n,), -1, dtype=torch.long, device=dev)
        first.scatter_reduce_(0, rows, torch.arange(len(rows), device=dev), "amin", include_self=False)
        tokens = torch.as_tensor(np.concatenate(seqs), dtype=torch.long, device=dev)
        pos = torch.as_tensor(np.concatenate([np.arange(L) for L in lens]), device=dev)
        cos, sin = ref.rope_tables(max(lens), m["dr"], c["rope_theta"], dev)
        cos, sin = cos[pos], sin[pos]
        x = params["embed"][tokens]
        for key, L, bias in (("dense_layers", m["Ld"], None), ("layers", m["Lm"], params[BUFFERS]["e_bias"])):
            for i in range(L):
                lw = {name: w[i] for name, w in params[key].items()}
                x = checkpoint(self.layer, x, cos, sin, bounds, first, rows, n_pad, lw,
                               None if bias is None else bias[i], i, use_reentrant=False)
        h = ref.rms_norm(x, params["final_norm"], c["rms_norm_eps"])
        w_lp = np.concatenate([np.r_[np.full(L - 1, a["w_logprobs"] / (L - 1)), 0.0] for L, a in zip(lens, attachs)])
        w_ent = np.concatenate([np.full(L, a["w_entropy"] / L) for L, a in zip(lens, attachs)])
        nxt = torch.cat([torch.cat([tokens[a + 1:b], tokens.new_full((1,), -1)]) for a, b in bounds])
        w_lp, w_ent = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (w_lp, w_ent))
        loss = 0.0
        for r in range(0, len(tokens), ref.LM_ROWS):
            lp, ent = checkpoint(self._row_stats, h[r:r + ref.LM_ROWS], params["lm_head"], nxt[r:r + ref.LM_ROWS],
                                 use_reentrant=False)
            loss = loss + torch.sum(w_lp[r:r + ref.LM_ROWS] * lp) + torch.sum(w_ent[r:r + ref.LM_ROWS] * ent)
        return loss


    def _row_stats(self, h, w, nxt):
        """``model.Model._row_stats``: (log p of the next token, 0 where
        there is none; entropy) per row."""
        return ref.Model._row_stats(self, h, w, nxt)


# ---------------------------------------------------------------- training


def float_tree(params: dict, requires_grad: bool = False) -> dict:
    """A float32 copy of a weight tree: each stacked layer weight as a list
    of its layers' tensors (``model.float_tree``'s reason), the buffers
    copied and never requiring grads."""
    def copy(t, grad):
        return t.detach().to(torch.float32, copy=True).requires_grad_(grad)

    out = {}
    for key, val in params.items():
        if key in ("dense_layers", "layers"):
            out[key] = {n: [copy(w[i], requires_grad) for i in range(w.shape[0])] for n, w in val.items()}
        elif key == BUFFERS:
            out[key] = {n: copy(w, False) for n, w in val.items()}
        else:
            out[key] = copy(val, requires_grad)
    return out


def _stacked(path: str) -> bool:
    return path.startswith(("layers.", "dense_layers."))


def train_steps(cfg: dict, make_weights, batches: list, lr: float, clip: float, precision: str = "fp32",
                against: dict | None = None, keep_first: bool = False, route_log: list | None = None,
                forced: list | None = None) -> dict:
    """``model.train_steps`` for this architecture: the program's first
    training steps followed from the same weights (`make_weights()`, the
    bf16 tree with its buffers) on the same batches, each batch run layer by
    layer (``Model.batch_loss``). Returns {"loss": [per step], "grad_norm":
    {leaf: norm of the first step's clipped grad}, "change_norm": {leaf:
    norm of the change after the last step}}, with "grad_diff_norm" {name:
    {leaf: norm}} against each of `against` ({name: ([per trained leaf,
    another side's first clipped grad / scale], scale)}) and, with
    `keep_first`, "first_grad" (this side's, bf16, host). The bias is read,
    never trained. "routes" [step][MoE layer] holds the idx [n, k] routed.

    `forced` ([step][MoE layer] idx [rows >= n, k], another side's
    "routes") makes every MoE layer route the trie's rows to those experts
    in place of its own top-k; the weights are still this side's sigmoids
    of them. Then "route_gap" is the largest selection deficit of a forced
    choice: this side's k-th largest sigmoid + bias of the row less its
    value at the forced expert (0 where the expert is in its top-k; inf
    where a row names an expert twice or one out of range), and
    "route_flips" the share of forced (row, choice) pairs off this side's
    own top-k."""
    model = Model(cfg, precision, route_log, forced)
    weights = make_weights()
    params = float_tree(weights, requires_grad=True)
    start = [w.to("cpu") for _, w in trained_leaves(weights)]  # bf16, off the card
    del weights
    named = trained_leaves(params)
    paths = [".".join(p) for p, _ in named]
    parts = [v if isinstance(v, list) else [v] for _, v in named]  # a leaf's layers
    leaves = [t for part in parts for t in part]
    opt = ref.AdamW(leaves, lr, clip, host=True)
    out = {"loss": []}
    dev = leaves[0].device

    def by_leaf(values):
        it = iter(values)
        return [[next(it) for _ in part] for part in parts]

    def norm(xs):
        return math.sqrt(sum(x * x for x in xs))

    with ref.float32_exact():
        for i, (seqs, attachs) in enumerate(batches):
            model.step = i
            loss = model.batch_loss(params, seqs, attachs)
            loss.backward()
            total = float(loss.detach())
            del loss
            clipped = by_leaf(opt.step([t.grad for t in leaves]))
            if i == 0:
                out["grad_norm"] = {p: norm(float(torch.linalg.vector_norm(g)) for g in gs)
                                    for p, gs in zip(paths, clipped)}
                out["grad_diff_norm"] = {
                    name: {p: norm(ref.diff_norm(g, o[l] if _stacked(p) else o, scale) for l, g in enumerate(gs))
                           for p, gs, o in zip(paths, clipped, other)}
                    for name, (other, scale) in (against or {}).items()}
                if keep_first:
                    out["first_grad"] = [torch.stack([g.to("cpu", torch.bfloat16) for g in gs]) if _stacked(p)
                                         else gs[0].to("cpu", torch.bfloat16) for p, gs in zip(paths, clipped)]
                    out["first_grad_scale"] = 1.0
            for t in leaves:
                t.grad = None
            out["loss"].append(total)
            if dev.type == "cuda":
                torch.cuda.empty_cache()  # the next step's blocks come in other sizes
    out["change_norm"] = {
        p: norm(float(torch.linalg.vector_norm(t.detach() - (w[l] if _stacked(p) else w).to(dev, torch.float32)))
                for l, t in enumerate(ts))
        for p, ts, w in zip(paths, parts, start)}
    out["routes"] = [[model.routes[i, at] for at in range(model.m["Lm"])] for i in range(len(batches))]
    if forced is not None:
        out["route_gap"], out["route_flips"] = model.route_gap, model.route_flips[0] / max(1, model.route_flips[1])
    return out
