"""The plain reference: Qwen3 and Qwen3-MoE in float32 PyTorch.

Nothing here comes from the program: no kernel, no trie, no weights it
made. Each sequence is replayed densely (causal attention over its own
tokens), so a trie's shared prefixes are computed once per sequence that
holds them. Layers follow the published Qwen3 equations: RMSNorm, q/k/v
projections, per-head q/k RMSNorm, rotate-half RoPE, grouped-query causal
softmax attention, output projection, residual, RMSNorm, SwiGLU MLP (or the
MoE block: softmax router, top-k renormalised, SwiGLU experts), residual; a
final RMSNorm and the LM head (the tied embedding or its own). A dense
model's batch runs one sequence at a time; a MoE model's runs layer by
layer over all its sequences, because the configuration's capacity
dispatch (which pairs each expert keeps) depends on every token routed in
the step, in the order the trie holds them (``trie_rows``).

Matrix products go through a `Matmul`: ``FP32`` computes in float32 with
TF32 off (``float32_exact``); ``FP8`` rounds both operands of every
product, forward and backward, to float8 e4m3 with a per-tensor scale
first: the control, one precision below the bfloat16 the configurations
state.

The training step's loss is the port's linear weighted loss per sequence,
``w_logprobs * mean(log p of tokens 1..L-1) + w_entropy * mean(entropy at
positions 0..L-1)``, summed over the batch; the optimizer is optax's
``clip_by_global_norm`` then ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, no
decay), with float32 moments, and the parameters stored in bfloat16
between steps, as the configuration states them.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
LM_ROWS = 1024  # rows of [rows, V] float32 logits formed at once
ATTN_ROWS = 1024  # query rows of [hq, rows, keys] float32 scores formed at once


@contextlib.contextmanager
def float32_exact():
    """Float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_e4m3(a), to_e4m3(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_e4m3(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def FP32(a, b):
    return a @ b


def FP8(a, b):
    return _Fp8Matmul.apply(a, b)


PRECISIONS = {"fp32": FP32, "fp8": FP8}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, cos, sin):
    """x [T, H, dh]; rotate-half over the head dim."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def rope_tables(T: int, dh: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, dh // 2, dtype=torch.float64, device=device) / (dh // 2))
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def attention(q, k, v, mm):
    """Causal grouped-query attention: q [T, hq, dh], k, v [T, hkv, dh]
    -> [T, hq * dh]; q head h reads kv head h // (hq / hkv). Queries go in
    blocks of ATTN_ROWS, each against the keys up to its last row, so no
    [hq, T, T] score matrix exists at once."""
    T, hq, dh = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = []
    for r in range(0, T, ATTN_ROWS):
        end = min(r + ATTN_ROWS, T)
        s = mm(q[:, r:end], k[:, :end].transpose(1, 2)) * dh ** -0.5  # [hq, rows, end]
        causal = torch.ones(end - r, end, dtype=torch.bool, device=q.device).tril(r)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out.append(mm(p, v[:, :end]))
    return torch.cat(out, dim=1).transpose(0, 1).reshape(T, hq * dh)


class Model:
    """A configuration's reference forward. `cfg` is a ``configs/*.json``
    dict; `params` a float32 tree in the port's layout."""

    def __init__(self, cfg: dict, precision: str = "fp32", route_log: list | None = None):
        self.cfg = cfg
        self.mm = PRECISIONS[precision]
        self.route_log = route_log  # a MoE model's first forward's routing, a dict a layer, where given

    def attn_part(self, x, cos, sin, ln1, wq, wk, wv, wo, q_norm, k_norm):
        """x plus one sequence's attention sublayer."""
        c, mm = self.cfg, self.mm
        T, eps, dh = x.shape[0], c["rms_norm_eps"], c["head_dim"]
        h = rms_norm(x, ln1, eps)
        q = mm(h, wq).reshape(T, -1, dh)
        k = mm(h, wk).reshape(T, -1, dh)
        v = mm(h, wv).reshape(T, -1, dh)
        q = rope(rms_norm(q, q_norm, eps), cos, sin)
        k = rope(rms_norm(k, k_norm, eps), cos, sin)
        return x + mm(attention(q, k, v, mm), wo)

    def layer(self, x, cos, sin, ln1, ln2, wq, wk, wv, wo, gate, up, down, q_norm, k_norm):
        mm = self.mm
        x = self.attn_part(x, cos, sin, ln1, wq, wk, wv, wo, q_norm, k_norm)
        h = rms_norm(x, ln2, self.cfg["rms_norm_eps"])
        return x + mm(F.silu(mm(h, gate)) * mm(h, up), down)

    def hidden(self, params: dict, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """Final-normed hidden states [T, d] of one sequence (positions
        0..T-1); `remat` recomputes each layer in the backward."""
        c = self.cfg
        cos, sin = rope_tables(tokens.shape[0], c["head_dim"], c["rope_theta"], tokens.device)
        names = ("ln1", "ln2", "wq", "wk", "wv", "wo", "gate", "up", "down", "q_norm", "k_norm")
        stacks = [params["layers"][n] for n in names]
        x = params["embed"][tokens]
        for i in range(c["num_hidden_layers"]):
            ws = [s[i] for s in stacks]
            x = (checkpoint(self.layer, x, cos, sin, *ws, use_reentrant=False) if remat
                 else self.layer(x, cos, sin, *ws))
        return rms_norm(x, params["final_norm"], c["rms_norm_eps"])

    def head(self, params: dict) -> torch.Tensor:
        return params["embed"].t() if self.cfg["tie_word_embeddings"] else params["lm_head"]

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return self.mm(hidden, self.head(params))

    def _stats(self, h, w, nxt):
        """(Σ log p of the next tokens, Σ entropy) of a block of rows; `nxt`
        [rows] the next token, -1 where there is none."""
        logits = self.mm(h, w)
        lse = torch.logsumexp(logits, dim=-1)
        ent = lse - torch.sum(torch.softmax(logits, dim=-1) * logits, dim=-1)
        has = nxt >= 0
        lp = logits[has].gather(1, nxt[has][:, None])[:, 0] - lse[has]
        return lp.sum(), ent.sum()

    def seq_loss(self, params: dict, tokens: torch.Tensor, w_lp: float, w_ent: float) -> torch.Tensor:
        """The linear weighted loss of one sequence, differentiable."""
        T = tokens.shape[0]
        h = self.hidden(params, tokens)
        w = self.head(params)
        nxt = torch.cat([tokens[1:], tokens.new_full((1,), -1)])
        sum_lp = sum_ent = 0.0
        for r in range(0, T, LM_ROWS):
            lp, ent = checkpoint(self._stats, h[r:r + LM_ROWS], w, nxt[r:r + LM_ROWS], use_reentrant=False)
            sum_lp, sum_ent = sum_lp + lp, sum_ent + ent
        return w_lp * sum_lp / (T - 1) + w_ent * sum_ent / T


    # ---------------------------------------------------------------- MoE

    def moe_block(self, hn, router, e_gate, e_up, e_down, n_pad: int):
        """Qwen3-MoE's block over the trie's tokens hn [n, d] in DFS order,
        with the configuration's capacity dispatch: softmax router, top-k
        renormalised; the (row, choice) pairs in row-major order, sorted
        stably by expert, the first ceil(factor * n_pad * k / E) of each
        expert kept, the rest dropped (n_pad: the rows routed, the trie's
        padding included). Returns (y [n, d], the load-balance loss
        E * sum_e f_e * mean_prob_e)."""
        c, mm = self.cfg, self.mm
        n, d = hn.shape
        E, k = c["num_experts"], c["num_experts_per_tok"]
        cap = math.ceil(c["assumed"]["moe_capacity_factor"] * n_pad * k / E)
        probs = torch.softmax(mm(hn, router), dim=-1)
        w, idx = torch.topk(probs, k, dim=-1)
        if c["norm_topk_prob"]:
            w = w / w.sum(dim=-1, keepdim=True)
        counts = torch.bincount(idx.reshape(-1), minlength=E).float()
        lb = E * torch.sum(counts / (n * k) * probs.mean(dim=0))
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        start = torch.searchsorted(flat[order], torch.arange(E, device=hn.device))
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n * k, device=hn.device) - start[flat[order]]
        keep = rank < cap
        if self.route_log is not None and len(self.route_log) < c["num_hidden_layers"]:
            top = torch.topk(probs.detach(), k + 1, dim=-1).values
            self.route_log.append({"idx": idx.detach().cpu(), "margin": (top[:, k - 1] - top[:, k]).cpu(),
                                   "dropped": int((~keep).sum()), "pairs": n * k})
        pair = order[keep[order]]  # the kept pairs, by expert
        rows = hn[pair // k]
        outs, at = [], 0
        for e, size in enumerate(torch.bincount(flat[pair], minlength=E).tolist()):
            if size:
                xe = rows[at:at + size]
                outs.append(mm(F.silu(mm(xe, e_gate[e])) * mm(xe, e_up[e]), e_down[e]))
                at += size
        y = hn.new_zeros(n, d).index_add(0, pair // k, torch.cat(outs) * w.reshape(-1)[pair][:, None])
        return y, lb

    def moe_layer(self, x, cos, sin, bounds, first, node_of, n_pad, ln1, ln2, wq, wk, wv, wo, router, e_gate,
                  e_up, e_down, q_norm, k_norm):
        """One layer over the batch's concatenated sequences x [N, d]:
        attention within each sequence (bounds; each recomputed alone in the
        backward), then the MoE block over the trie's tokens (the first copy
        of each, `first`), its output handed to every copy (`node_of`)."""
        x = torch.cat([checkpoint(self.attn_part, x[a:b], cos[a:b], sin[a:b], ln1, wq, wk, wv, wo, q_norm, k_norm,
                                  use_reentrant=False) for a, b in bounds])
        y, lb = self.moe_block(rms_norm(x[first], ln2, self.cfg["rms_norm_eps"]), router, e_gate.unbind(0),
                               e_up.unbind(0), e_down.unbind(0), n_pad)
        return x + y[node_of], lb

    def batch_loss(self, params: dict, seqs, attachs) -> torch.Tensor:
        """The linear weighted loss of a whole batch, summed over its
        sequences, plus router_aux_loss_coef times the layers' load-balance
        losses: the layers run over all sequences at once (the capacity
        dispatch couples them), each recomputed in the backward."""
        c = self.cfg
        dev = params["embed"].device
        node_of, n = trie_rows(seqs)
        n_pad = -(-n // PAD_ROWS) * PAD_ROWS
        lens = [len(s) for s in seqs]
        ends = np.cumsum(lens)
        bounds = [(int(e - L), int(e)) for e, L in zip(ends, lens)]
        rows = torch.as_tensor(np.concatenate(node_of), device=dev)
        first = torch.full((n,), -1, dtype=torch.long, device=dev)
        first.scatter_reduce_(0, rows, torch.arange(len(rows), device=dev), "amin", include_self=False)
        tokens = torch.as_tensor(np.concatenate(seqs), dtype=torch.long, device=dev)
        pos = torch.as_tensor(np.concatenate([np.arange(L) for L in lens]), device=dev)
        cos, sin = rope_tables(max(lens), c["head_dim"], c["rope_theta"], dev)
        cos, sin = cos[pos], sin[pos]
        names = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "e_gate", "e_up", "e_down", "q_norm", "k_norm")
        stacks = [params["layers"][nm] for nm in names]
        x = params["embed"][tokens]
        lb = 0.0
        for i in range(c["num_hidden_layers"]):
            x, lb_i = checkpoint(self.moe_layer, x, cos, sin, bounds, first, rows, n_pad, *[st[i] for st in stacks],
                                 use_reentrant=False)
            lb = lb + lb_i
        h = rms_norm(x, params["final_norm"], c["rms_norm_eps"])
        w_lp = np.concatenate([np.r_[np.full(L - 1, a["w_logprobs"] / (L - 1)), 0.0] for L, a in zip(lens, attachs)])
        w_ent = np.concatenate([np.full(L, a["w_entropy"] / L) for L, a in zip(lens, attachs)])
        nxt = torch.cat([torch.cat([tokens[a + 1:b], tokens.new_full((1,), -1)]) for a, b in bounds])
        w_lp, w_ent = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (w_lp, w_ent))
        loss = c["router_aux_loss_coef"] * lb
        for r in range(0, len(tokens), LM_ROWS):
            lp, ent = checkpoint(self._row_stats, h[r:r + LM_ROWS], self.head(params), nxt[r:r + LM_ROWS],
                                 use_reentrant=False)
            loss = loss + torch.sum(w_lp[r:r + LM_ROWS] * lp) + torch.sum(w_ent[r:r + LM_ROWS] * ent)
        return loss

    def _row_stats(self, h, w, nxt):
        """(log p of the next token, 0 where there is none; entropy) per row."""
        logits = self.mm(h, w)
        lse = torch.logsumexp(logits, dim=-1)
        ent = lse - torch.sum(torch.softmax(logits, dim=-1) * logits, dim=-1)
        lp = logits.gather(1, nxt.clamp(min=0)[:, None])[:, 0] - lse
        return torch.where(nxt >= 0, lp, torch.zeros_like(lp)), ent


PAD_ROWS = 128  # the program pads a trie to a multiple of this many rows, and routes them all


def trie_rows(seqs) -> tuple[list, int]:
    """([per sequence, its tokens' rows], n): the trie's tokens numbered in
    DFS order, the order the program routes them in: the sequences in
    lexicographic order, each adding the tokens past its longest common
    prefix with the one before."""
    order = sorted(range(len(seqs)), key=lambda i: np.asarray(seqs[i]).tolist())
    rows, n, prev = [None] * len(seqs), 0, None
    for i in order:
        s = np.asarray(seqs[i])
        lcp = 0
        if prev is not None:
            p = np.asarray(seqs[prev])
            m = min(len(s), len(p))
            ne = np.nonzero(s[:m] != p[:m])[0]
            lcp = int(ne[0]) if len(ne) else m
        r = np.empty(len(s), np.int64)
        if lcp:
            r[:lcp] = rows[prev][:lcp]
        r[lcp:] = np.arange(n, n + len(s) - lcp)
        n += len(s) - lcp
        rows[i], prev = r, i
    return rows, n


# ------------------------------------------------------------------ training


def float_tree(params: dict, requires_grad: bool = False) -> dict:
    """A float32 copy of a weight tree, each stacked layer weight as a list
    of its layers' tensors (a stacked leaf's grad would be stacked from the
    layers' grads at the end of the backward, twice its size at once)."""
    def copy(t):
        return t.detach().to(torch.float32, copy=True).requires_grad_(requires_grad)

    return {key: ({n: [copy(w[i]) for i in range(w.shape[0])] for n, w in val.items()} if key == "layers"
                  else float_tree(val, requires_grad) if isinstance(val, dict) else copy(val))
            for key, val in params.items()}


def tree_leaves(tree: dict, prefix: tuple = ()) -> list:
    out = []
    for key, val in tree.items():
        out += tree_leaves(val, prefix + (key,)) if isinstance(val, dict) else [(prefix + (key,), val)]
    return out


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr))`` with float32
    moments (kept in host memory where `host` is set: a MoE model's do not
    fit on the card beside its float32 params and grads, and are updated
    there slice by slice); the parameters are rounded to bfloat16 after each
    update."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    SLICE = 1 << 27  # elements of a moment moved to the card at once

    def __init__(self, params: list, lr: float, clip: float, host: bool = False):
        self.params, self.lr, self.clip = params, lr, clip
        where = "cpu" if host else None
        self.mu = [torch.zeros_like(p, device=where) for p in params]
        self.nu = [torch.zeros_like(p, device=where) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list) -> list:
        """Updates the params in place; returns the clipped grads."""
        norm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in grads))
        if self.clip and norm >= self.clip:
            for g in grads:
                g.mul_(self.clip / norm)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, mu_all, nu_all in zip(self.params, grads, self.mu, self.nu):
            rows = max(1, self.SLICE // max(1, p[0].numel())) if p.dim() else 1
            for r in range(0, p.shape[0] if p.dim() else 1, rows):
                sl = slice(r, r + rows) if p.dim() else ...
                mu, nu = mu_all[sl].to(p.device), nu_all[sl].to(p.device)
                mu.mul_(self.b1).add_(g[sl], alpha=1 - self.b1)
                nu.mul_(self.b2).add_(g[sl] * g[sl], alpha=1 - self.b2)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                p[sl].copy_((p[sl] - self.lr * u).to(torch.bfloat16).float())
                mu_all[sl].copy_(mu)
                nu_all[sl].copy_(nu)
        return grads


def train_steps(cfg: dict, make_weights, batches: list, lr: float, clip: float, precision: str = "fp32",
                against: dict | None = None, keep_first: bool = False, route_log: list | None = None) -> dict:
    """Follows the program's first training steps from the same weights
    (`make_weights()`, the bf16 tree) on the same batches: {"loss": [per
    step], "grad_norm": {leaf: norm of the first step's clipped grad},
    "change_norm": {leaf: norm of the params' change after the last step}}.
    `against` {name: ([per leaf, another side's first clipped grad /
    scale], scale)} adds "grad_diff_norm" {name: {leaf: norm of the
    difference}}; `keep_first` adds "first_grad", this side's, in host
    memory (bf16). `batches` [(seqs, attachs)]. A dense model's loss and
    grads are summed one sequence at a time; a MoE model's batch runs layer
    by layer (``batch_loss``); its first step's routing goes to
    `route_log`, where given (``Model.route_log``)."""
    model = Model(cfg, precision, route_log)
    weights = make_weights()
    params = float_tree(weights, requires_grad=True)
    start = [w.to("cpu") for _, w in tree_leaves(weights)]  # bf16, off the card
    del weights
    named = tree_leaves(params)
    paths = [".".join(p) for p, _ in named]
    parts = [v if isinstance(v, list) else [v] for _, v in named]  # a leaf's layers
    leaves = [t for part in parts for t in part]
    moe = bool(cfg.get("num_experts", 0))
    opt = AdamW(leaves, lr, clip, host=moe)
    out = {"loss": []}
    dev = leaves[0].device

    def by_leaf(values):  # the flat per-layer list back into [per leaf, [per layer]]
        it = iter(values)
        return [[next(it) for _ in part] for part in parts]

    def norm(xs):
        return math.sqrt(sum(x * x for x in xs))

    with float32_exact():
        for i, (seqs, attachs) in enumerate(batches):
            if moe:
                loss = model.batch_loss(params, seqs, attachs)
                loss.backward()
                total = float(loss.detach())
            else:
                total = 0.0
                for seq, a in zip(seqs, attachs):
                    loss = model.seq_loss(params, torch.as_tensor(seq, dtype=torch.long, device=dev),
                                          a["w_logprobs"], a["w_entropy"])
                    loss.backward()
                    total += float(loss.detach())
            del loss
            clipped = by_leaf(opt.step([t.grad for t in leaves]))
            if i == 0:
                out["grad_norm"] = {p: norm(float(torch.linalg.vector_norm(g)) for g in gs)
                                    for p, gs in zip(paths, clipped)}
                out["grad_diff_norm"] = {
                    name: {p: norm(diff_norm(g, o[l] if p.startswith("layers.") else o, scale) for l, g in enumerate(gs))
                           for p, gs, o in zip(paths, clipped, other)}
                    for name, (other, scale) in (against or {}).items()}
                if keep_first:
                    out["first_grad"] = [torch.stack([g.to("cpu", torch.bfloat16) for g in gs]) if p.startswith("layers.")
                                         else gs[0].to("cpu", torch.bfloat16) for p, gs in zip(paths, clipped)]
                    out["first_grad_scale"] = 1.0
            for t in leaves:
                t.grad = None
            out["loss"].append(total)
            if dev.type == "cuda":
                torch.cuda.empty_cache()  # the next step's blocks come in other sizes
    out["change_norm"] = {
        p: norm(float(torch.linalg.vector_norm(t.detach() - (w[l] if p.startswith("layers.") else w).to(dev, torch.float32)))
                for l, t in enumerate(ts))
        for p, ts, w in zip(paths, parts, start)}
    return out


@torch.no_grad()
def diff_norm(g: torch.Tensor, other: torch.Tensor, scale: float) -> float:
    """||g - scale * other|| in float32 on g's device, a slice at a time."""
    if g.dim() == 0:
        return abs(float(g) - scale * float(other))
    rows = max(1, AdamW.SLICE // max(1, g[0].numel()))
    total = 0.0
    for r in range(0, g.shape[0], rows):
        d = g[r:r + rows] - other[r:r + rows].to(g.device, torch.float32) * scale
        total += float(torch.linalg.vector_norm(d)) ** 2
    return math.sqrt(total)


# ------------------------------------------------------------------- rollout


class Served:
    """The reference's float32 logits at the served positions of a
    sequence, its float32 copy of the weights made once."""

    def __init__(self, cfg: dict, weights: dict):
        self.cfg, self.params = cfg, float_tree(weights)

    @torch.no_grad()
    def logits(self, tokens, first: int, precision: str = "fp32") -> torch.Tensor:
        """[T - first, V] at positions first..T-1 of one sequence (position
        i predicts token i + 1)."""
        model, params = Model(self.cfg, precision), self.params
        dev = params["embed"].device
        with float32_exact():
            h = model.hidden(params, torch.as_tensor(tokens, dtype=torch.long, device=dev))
            return torch.cat([model.logits(params, h[r:r + LM_ROWS]) for r in range(first, h.shape[0], LM_ROWS)])
