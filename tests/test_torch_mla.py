"""The port's DeepSeek-V3 family (``models/deepseek_v3.py``: latent
attention, the sigmoid-routed MoE with shared experts, a leading dense
layer) against the benchmark's plain float32 reference
(``benchmark/reference/deepseek_v3.py``) at a tiny size on the CPU: d 64, 4
heads, q/k 16 + 8 wide, v 16, latent 32, 8 experts top-2, 1 shared, 1 dense
layer + 2 MoE layers, float32 weights drawn by the reference from a seed.
The JAX package has no such model: the reference is the plain one.

Tolerances, each with its reason: the port and the reference compute the
same float32 functions in other orders (the port's blocked attention with
its running max, fp32 sums over the k choices in order, autograd through
checkpoints). Measured here: values within 4e-7 of the reference relative
to their norm (RoPE 4e-8), gradients within 1.3e-6 per leaf; the limits,
1e-5 and 1e-4, leave an order of magnitude for other seeds and thread
counts and stay far under what a wrong term moves (planted in a copy: the
shared branch dropped 0.52, a tenth of the bias in the weights 5.6e-3,
half-split in place of interleaved RoPE 0.32). Routing is compared
exactly: the same float32 scores rank the same experts. The Trainer's first
gradient is compared with the reference's kept in bfloat16 (2^-9 relative
an element, 1.9e-3 a leaf measured), at 1e-2.
"""

from __future__ import annotations

import copy
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import generator  # noqa: E402  (the benchmark's traffic generator)
from reference import deepseek_v3 as dref  # noqa: E402
from reference import model as ref  # noqa: E402

from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine  # noqa: E402
from dynamictreeattn_tpu_torch.models import deepseek_v3 as dv3  # noqa: E402
from dynamictreeattn_tpu_torch.models import qwen3 as tq  # noqa: E402
from dynamictreeattn_tpu_torch.ops import tree_attention as _ta_fn  # noqa: E402,F401
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_attention_reference  # noqa: E402
from dynamictreeattn_tpu_torch.tries import TokenTrie  # noqa: E402
from dynamictreeattn_tpu_torch.utils import profiling  # noqa: E402

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]

CFG = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 3, "num_attention_heads": 4,
       "num_key_value_heads": 4, "vocab_size": 128, "rms_norm_eps": 1e-5, "rope_theta": 50000,
       "tie_word_embeddings": False, "attention_bias": False, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
       "moe_intermediate_size": 32, "n_shared_experts": 1, "first_k_dense_replace": 1, "norm_topk_prob": True,
       "routed_scaling_factor": 2.446, "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
       "topk_group": 1, "q_lora_rank": None, "rope_scaling": None,
       "assumed": {"moe_capacity_factor": 1.5, "router_aux_coef": 0.0}}
MIX = {"prompts_per_step": 2, "samples_per_prompt": 4, "prompt_len": [12, 20], "completion_len": [4, 10],
       "branch_prob": 0.85, "w_logprobs": -1.0, "w_entropy": 0.1, "pool": 2, "shape_seed": 7}
SEED = 5
VAL_REL = 1e-5  # float32 values in another order: a few ulps of their size
GRAD_REL = 1e-4  # float32 gradients, per leaf, relative to the leaf's norm (module docstring)


def port_config(cfg=CFG, **kw) -> dv3.DeepseekV3Config:
    a = cfg["assumed"]
    fields = dict(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"], head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]), num_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"], moe_intermediate_size=cfg["moe_intermediate_size"],
        router_aux_coef=a["router_aux_coef"], moe_capacity_factor=a["moe_capacity_factor"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        n_shared_experts=cfg["n_shared_experts"], first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=cfg["routed_scaling_factor"])
    return dv3.DeepseekV3Config(**dict(fields, **kw))


MC = port_config()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(cfg=CFG, seed=SEED) -> dict:
    return dref.make_weights(cfg, seed, "cpu", torch.float32)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).detach().norm() / b.detach().norm().clamp(min=1e-30))


def layer_weights(params: dict, key: str, i: int) -> dict:
    lw = {name: w[i] for name, w in params[key].items()}
    if key == "layers":
        lw["e_bias"] = params["buffers"]["e_bias"][i]
    return lw


def chain_attn(q, k, v, handoff=None):
    """The dense oracle on one sequence packed as a chain (causal)."""
    n = q.shape[1]
    return tree_attention_reference(q, k, v, torch.full((n,), n - 1, dtype=torch.int32))


# ------------------------------------------------------------------- RoPE


def test_interleaved_rope_is_the_pairwise_rotation_deinterleaved():
    """The port's RoPE of MLA (``apply_rope_interleaved``) is the published
    one: each pair (x_{2i}, x_{2i+1}) rotated by position * theta^(-2i/dr),
    the result laid out de-interleaved (the pairs' first elements, then
    their second), as ``modeling_deepseek.py``'s ``apply_rotary_pos_emb``
    returns it; equal to the half-split RoPE of the de-interleaved input,
    which is what a port storing the q_pe / k_pe weight rows permuted would
    run; and equal to the reference's."""
    T, H, dr, theta = 11, 3, 8, 50000.0
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(T, H, dr, generator=gen, dtype=torch.float64).float()
    pos = torch.arange(T)
    cos, sin = tq.rope_tables(pos, dr, theta)
    got = dv3.apply_rope_interleaved(x, cos, sin)
    ang = pos[:, None].double() * theta ** (-torch.arange(0, dr, 2, dtype=torch.float64) / dr)[None]  # [T, dr/2]
    a, b = x[..., 0::2].double(), x[..., 1::2].double()
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    want = torch.cat([a * c - b * s, a * s + b * c], dim=-1)
    assert rel(got.double(), want) < VAL_REL
    perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])
    assert torch.equal(got, tq.apply_rope(x[..., perm], cos, sin))
    rcos, rsin = ref.rope_tables(T, dr, theta, "cpu")
    assert rel(dref.rope_interleaved(x, rcos, rsin), got) < VAL_REL


# ---------------------------------------------------------------- routing


def route_inputs(n=40, seed=1):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(n, 64, generator=gen)
    router = torch.randn(64, 8, generator=gen) / 8
    bias = torch.randn(8, generator=gen) * dref.BIAS_STD
    return h, router, bias


def test_sigmoid_routing_selects_with_bias_and_weighs_without():
    """``deepseek_v3.route``: the top-k of sigmoid + bias chosen, the
    weights the chosen sigmoids (no bias) renormalised over their sum +
    1e-20 and times routed_scaling_factor; lb 0; exactly the reference's."""
    h, router, bias = route_inputs()
    w, idx, lb = dv3.route(h, router, bias, MC)
    s = torch.sigmoid(h @ router)
    want_idx = torch.topk(s + bias, 2, dim=-1).indices
    chosen = s.gather(1, want_idx)
    want_w = chosen / (chosen.sum(-1, keepdim=True) + 1e-20) * MC.routed_scaling_factor
    assert torch.equal(idx, want_idx) and torch.allclose(w, want_w, rtol=1e-6, atol=0)
    assert float(lb) == 0.0
    moved = ~(idx[:, :, None] == torch.topk(s, 2, dim=-1).indices[:, None, :]).any(-1)
    assert 0 < int(moved.sum()) < idx.numel()  # the bias moves some choices, not all


def test_bias_that_moves_a_choice_keeps_its_weight_bias_free():
    """A bias large on one expert makes every row choose it; its weight is
    still its sigmoid, not sigmoid + bias; the counter ``moe.bias_moved``
    counts the (row, choice) pairs off the bias-free top-k, once a training
    forward, real rows only."""
    h, router, _ = route_inputs()
    s = torch.sigmoid(h @ router)
    cold = int(torch.argmin(s.mean(0)))
    bias = torch.zeros(8)
    bias[cold] = 10.0
    valid = torch.ones(h.shape[0])
    valid[-5:] = 0
    parts = profiling.Parts(device_events=False)
    profiling.collect(parts)
    try:
        w, idx, _ = dv3.route(h.requires_grad_(), router, bias, MC, valid=valid)
    finally:
        profiling.collect(None)
    real = idx[:-5]
    assert (real == cold).any(-1).all() and (idx[-5:] == MC.num_experts).all()
    plain = torch.topk(s, 2, dim=-1).indices[:-5]
    moved = int((~(real[:, :, None] == plain[:, None, :]).any(-1)).sum())
    assert moved == int((~(plain == cold).any(-1)).sum()) > 0
    assert int(parts.take_counts()["moe.bias_moved"]) == moved
    at = (real == cold).float().argmax(-1)
    sw = s[:-5].gather(1, real)
    want = (s[:-5, cold] / (sw.sum(-1) + 1e-20)) * MC.routed_scaling_factor
    assert torch.allclose(w[:-5].detach().gather(1, at[:, None])[:, 0], want, rtol=1e-6)


def test_softmax_routing_is_bit_for_bit_the_expression_before_the_sigmoid_branch():
    """A Qwen3-MoE config's ``moe_route`` gives w and idx bit-equal to a copy
    of its expression before DeepSeek-V3's sigmoid routing was added."""
    mc = tq.MODEL_CONFIGS["qwen3-moe-tiny"]
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(50, mc.hidden_size, generator=gen).to(torch.bfloat16)
    router = (torch.randn(mc.hidden_size, mc.num_experts, generator=gen) / 8).to(torch.bfloat16)
    valid = (torch.arange(50) < 44).float()
    w, idx, _ = tq.moe_route(h, router, mc, valid)
    probs = torch.softmax(h.float() @ router.float(), dim=-1)
    ww, ii = torch.topk(probs, mc.num_experts_per_tok, dim=-1)
    ww = ww / torch.sum(ww, dim=-1, keepdim=True)
    ii = torch.where(valid[:, None] > 0, ii, mc.num_experts)
    assert torch.equal(w, ww) and torch.equal(idx, ii)


# ----------------------------------------------------------------- blocks


@pytest.mark.parametrize("factor", [1.5, 0.25])
def test_moe_block_with_shared_experts_is_the_references(factor):
    """The DeepSeek-V3 MoE block (routed experts through the capacity
    dispatch plus the shared branch) equals the reference's, with capacity
    to spare and with pairs dropped; and its gradients."""
    cfg = dict(CFG, assumed=dict(CFG["assumed"], moe_capacity_factor=factor))
    mc = port_config(cfg)
    params = weights(cfg)
    for w in params["layers"].values():
        w.requires_grad_(True)
    lw = layer_weights(params, "layers", 0)
    gen = torch.Generator().manual_seed(2)
    hn = torch.randn(100, 64, generator=gen, requires_grad=True)
    y, _ = dv3._moe_block(hn, lw, mc, capacity=tq.moe_capacity(mc, 128))
    model = dref.Model(cfg)
    want = model.moe_block(hn, lw["router"], lw["e_bias"], lw["e_gate"].unbind(0), lw["e_up"].unbind(0),
                           lw["e_down"].unbind(0), lw["s_gate"], lw["s_up"], lw["s_down"], 128)
    assert rel(y, want) < VAL_REL
    g = torch.randn(y.shape, generator=gen)
    leaves = [hn] + [lw[k] for k in ("router", "e_gate", "e_down", "s_gate", "s_down")]
    gy = torch.autograd.grad((y * g).sum(), leaves, retain_graph=True)
    gw = torch.autograd.grad((want * g).sum(), leaves)
    for a, b in zip(gy, gw):
        assert rel(a, b) < GRAD_REL


@pytest.mark.parametrize("key", ["dense_layers", "layers"])
def test_mla_layer_output_and_grads_are_the_references(key):
    """One layer (MLA, then the dense MLP or the MoE block) of one sequence:
    the port's ``_layer`` with the dense oracle as its attention against
    the reference's MLA sublayer and MLP / MoE block; the output and the
    gradients of the input and of every weight of the layer."""
    params = weights()
    for w in params[key].values():
        w.requires_grad_(True)
    lw = layer_weights(params, key, 0)
    gen = torch.Generator().manual_seed(4)
    T = 37
    x = torch.randn(T, 64, generator=gen, requires_grad=True)
    cos, sin = tq.rope_tables(torch.arange(T), 8, 50000.0)
    y, _ = dv3._layer(x, lw, cos, sin, MC, chain_attn, capacity=tq.moe_capacity(MC, 128))
    model = dref.Model(CFG)
    rcos, rsin = ref.rope_tables(T, 8, 50000.0, "cpu")
    xr = model.attn_part(x, rcos, rsin, *(lw[n] for n in ("ln1", "wq", "wkv_a", "kv_norm", "wkv_b", "wo")))
    hn = ref.rms_norm(xr, lw["ln2"], 1e-5)
    if key == "dense_layers":
        want = xr + model.dense_mlp(hn, lw["gate"], lw["up"], lw["down"])
    else:
        want = xr + model.moe_block(hn, lw["router"], lw["e_bias"], lw["e_gate"].unbind(0), lw["e_up"].unbind(0),
                                    lw["e_down"].unbind(0), lw["s_gate"], lw["s_up"], lw["s_down"], 128)
    assert rel(y, want) < VAL_REL
    g = torch.randn(y.shape, generator=gen)
    leaves = [x] + list(params[key].values())
    gy = torch.autograd.grad((y * g).sum(), leaves, retain_graph=True)
    gw = torch.autograd.grad((want * g).sum(), leaves)
    for name, a, b in zip(["x"] + list(params[key]), gy, gw):
        assert rel(a, b) < GRAD_REL, name


# ------------------------------------------------------------ whole model


def batch(seed=SEED, b=0):
    return generator.train_pool(MIX, CFG["vocab_size"], seed)[b]


def reference_grads(params, seqs, attachs):
    fp = dref.float_tree(params, requires_grad=True)
    with ref.float32_exact():
        loss = dref.Model(CFG).batch_loss(fp, seqs, attachs)
        loss.backward()
    grads = {".".join(p): (torch.stack([t.grad for t in v]) if isinstance(v, list) else v.grad)
             for p, v in dref.trained_leaves(fp)}
    return float(loss.detach()), grads


@pytest.mark.parametrize("remat,bwd_mode", [(False, "auto"), (True, "auto"), (True, "fused")])
def test_engine_loss_and_every_grad_match_dense_replay(remat, bwd_mode):
    """``TreeEngine.loss_and_grad`` on a forked trie (the port's plain kernel
    versions, as on the card but for the CUDA launches) against the
    reference's dense replay: the loss, and every trained leaf's gradient
    (the routing bias has none)."""
    params = weights()
    seqs, attachs = batch()
    engine = TreeEngine(MC, EngineConfig(remat=remat, bwd_mode=bwd_mode, block_q=64, block_kv=64), device="cpu")
    tb = engine.prepare(TokenTrie(seqs, attachs))
    assert tb.packed.n_tokens < sum(len(s) for s in seqs)  # the trie shares prefixes
    loss, grads, aux = engine.loss_and_grad(params, tb)
    assert "buffers" not in grads and float(aux["lb_loss"]) == 0.0
    want_loss, want = reference_grads(params, seqs, attachs)
    assert abs(float(loss) - want_loss) <= VAL_REL * abs(want_loss)
    names, leaves = zip(*[(".".join(p), t) for p, t in ref.tree_leaves(grads)])
    assert list(names) == list(want)
    for name, g in zip(names, leaves):
        assert rel(g, want[name]) < GRAD_REL, name


def test_trainer_step_matches_the_reference_step():
    """One ``Trainer.train_step`` (fp32 params, the default engine) against
    the reference's first step: the loss, and each leaf's first clipped
    gradient as the optimizer got it (its first moment / (1 - b1)) against
    the reference's clipped gradient; the routing bias unchanged and out of
    the optimizer's state."""
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    params = weights()
    pool = generator.train_pool(MIX, CFG["vocab_size"], SEED)
    trainer = Trainer(MC, EngineConfig(), TrainConfig(learning_rate=1e-2, grad_clip=1.0, param_dtype="fp32"),
                      device="cpu")
    trainer.set_params(params)
    loss = trainer.train_step(*pool[0])["loss"]
    want = dref.train_steps(CFG, lambda: weights(), pool[:1], 1e-2, 1.0, keep_first=True)
    assert abs(loss - want["loss"][0]) <= VAL_REL * abs(want["loss"][0])
    paths = [p for p, _ in dref.trained_leaves(params)]
    assert len(trainer.opt_state["mu"]) == len(paths)
    for p, mu, g in zip(paths, trainer.opt_state["mu"], want["first_grad"]):
        assert rel(mu.float() / 0.1, g.float()) < 1e-2, p  # the reference's is kept in bf16: 2^-8 relative
    assert torch.equal(trainer.params["buffers"]["e_bias"], params["buffers"]["e_bias"])


def test_reference_follows_a_forced_routing_and_reads_its_deficit():
    """The reference routed as another side chose (``train_steps``'s
    `forced`): its own choices forced give its own losses and first grads
    bit for bit, route_gap and route_flips 0; one choice moved off a row's
    top-k reads a deficit above 0 and at least that pair flipped; a row
    that names an expert twice, or a routing of another trie, reads inf."""
    pool = generator.train_pool(MIX, CFG["vocab_size"], SEED)

    def steps(forced):
        return dref.train_steps(CFG, lambda: weights(), pool[:2], 1e-2, 1.0, keep_first=True, forced=forced)

    own = dref.train_steps(CFG, lambda: weights(), pool[:2], 1e-2, 1.0, keep_first=True)
    assert len(own["routes"]) == 2 and len(own["routes"][0]) == CFG["num_hidden_layers"] - 1
    same = steps(own["routes"])
    assert same["loss"] == own["loss"] and same["route_gap"] == 0.0 and same["route_flips"] == 0.0
    assert all(torch.equal(a, b) for a, b in zip(same["first_grad"], own["first_grad"]))
    pairs = sum(r.numel() for step in own["routes"] for r in step)
    moved = [[r.clone() for r in step] for step in own["routes"]]
    row = moved[0][0][3]
    row[1] = next(e for e in range(CFG["n_routed_experts"]) if e not in row.tolist())
    got = steps(moved)
    assert 0.0 < got["route_gap"] < math.inf and got["route_flips"] >= 1 / pairs
    twice = [[r.clone() for r in step] for step in own["routes"]]
    twice[1][0][5, 1] = twice[1][0][5, 0]
    assert steps(twice)["route_gap"] == math.inf
    short = [[r[:-1] for r in step] for step in own["routes"]]
    assert steps(short)["route_gap"] == math.inf


def test_tree_and_dense_packings_agree_in_the_port():
    """The port's own oracle: the same batch as a trie and as dense chains
    (``pack_sequences_dense``) gives the same loss and grads (the capacity
    rows differ: capacity to spare, so no pair drops either way)."""
    from dynamictreeattn_tpu_torch.engine import pack_sequences_dense

    mc = port_config(moe_capacity_factor=4.0)
    params = weights()
    seqs, attachs = batch()
    engine = TreeEngine(mc, EngineConfig(remat=False, block_q=64, block_kv=64), device="cpu")
    lt, gt, _ = engine.loss_and_grad(params, engine.prepare(TokenTrie(seqs, attachs)))
    ld, gd, _ = engine.loss_and_grad(params, engine.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=64)))
    assert abs(float(lt) - float(ld)) <= VAL_REL * abs(float(ld))
    for (p, a), (_, b) in zip(ref.tree_leaves(gt), ref.tree_leaves(gd)):
        assert rel(a, b) < GRAD_REL, p


def test_engine_forward_logprobs_run():
    """The inference forward (``TreeEngine.forward``) runs the same model:
    its log-probs equal the training path's per-edge log-probs."""
    params = weights()
    seqs, attachs = batch()
    engine = TreeEngine(MC, EngineConfig(block_q=64, block_kv=64), device="cpu")
    tb = engine.prepare(TokenTrie(seqs, attachs))
    out = engine.forward(params, tb)
    assert len(out) == len(seqs)
    lp, _ = engine.logprobs(params, tb)
    assert all(np.isfinite(v).all() for v in out.values()) and torch.isfinite(lp).all()


# ------------------------------------------------------------------ gates


def test_kernel_gate_takes_mla_widths_at_group_one():
    assert ta.kernel_takes(192, 1, 128)
    assert not ta.kernel_takes(192, 2, 128) and not ta.kernel_takes(192, 1) and not ta.kernel_takes(128, 1, 64)
    assert ta.kmajor_key(192, 128) in ta.KMAJOR_CTAS_PER_SM and ta.kmajor_key(128, 128) == 128
    assert TreeEngine(MC, device="cpu").mc.attn_widths == (24, 16)


def mla_inputs(n=128, H=2, dqk=192, dv=128):
    q4 = torch.zeros((H, 1, n, dqk), dtype=torch.bfloat16)
    k = torch.zeros((H, n, dqk), dtype=torch.bfloat16)
    v = torch.zeros((H, n, dv), dtype=torch.bfloat16)
    meta = [torch.zeros((n // 64, 1), dtype=torch.int32), torch.zeros(n // 64, dtype=torch.int32),
            torch.zeros((n // 64, 1), dtype=torch.int32)]
    tail = (torch.zeros((H, 1, n, dv), dtype=torch.bfloat16), torch.zeros((H, 1, n)), torch.zeros((H, 1, n)))
    return q4, k, v, torch.arange(n, dtype=torch.int32), meta, tail


def test_split_backward_refuses_mla_widths_before_any_launch():
    """K11 and K12 (``bwd_mode="split"``) refuse q/k and v of different
    widths with a clear error, before the library loads; the input checks
    take MLA's (192, 128) at group 1 and refuse it at group 2."""
    q4, k, v, ld, meta, tail = mla_inputs()
    ta._check_inputs(q4, k, v, ld, *meta, 64, 64)
    ta._check_grad_inputs(q4, tail[0], tail[1], tail[2], v.shape[-1])
    with pytest.raises(ValueError, match="K12"):
        ta._launch_kmajor("tree_attn_bwd_dkv", q4, k, v, ld, *meta, *tail, 0.1, 64, 64, None)
    with pytest.raises(ValueError, match="K11"):
        ta._launch_dq(q4, k, v, ld, *meta, *tail, 0.1, 64, 64, None)
    with pytest.raises(ValueError, match="head_dim"):
        ta._check_inputs(q4.expand(2, 2, -1, -1).contiguous(), k, v, ld, *meta, 64, 64)


def test_unported_paths_raise_not_implemented():
    """Sampling (the rollout) and every parallelism raise
    NotImplementedError for an MLA model."""
    from dynamictreeattn_tpu_torch.models.generate import generate, generate_grouped
    from dynamictreeattn_tpu_torch.parallel.pipeline import make_pp_train_step
    from dynamictreeattn_tpu_torch.parallel.train import make_train_step
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    params = weights()
    prompts, lens = np.zeros((1, 4), np.int32), np.array([4], np.int32)
    with pytest.raises(NotImplementedError, match="latent decode cache"):
        generate_grouped(params, MC, prompts, lens, 2, 3)
    with pytest.raises(NotImplementedError, match="latent decode cache"):
        generate(params, MC, prompts, lens, 3)
    trainer = Trainer(MC, EngineConfig(), TrainConfig(), device="cpu")
    trainer.set_params(params)
    with pytest.raises(NotImplementedError):
        trainer.rollout(prompts, lens, 2, 3)
    for tc in (TrainConfig(tp=2), TrainConfig(sp=2), TrainConfig(pp=2), TrainConfig(ep=True)):
        with pytest.raises(NotImplementedError, match="one device"):
            Trainer(MC, EngineConfig(), tc, device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        make_train_step(MC, device="cpu", ep=True)
    with pytest.raises(NotImplementedError, match="pipeline"):
        make_pp_train_step(MC, None)


@pytest.mark.parametrize("change", [dict(head_dim=32), dict(num_key_value_heads=2), dict(scoring_func="softmax"),
                                    dict(use_qk_norm=True)])
def test_config_refuses_what_is_not_deepseek_v3(change):
    with pytest.raises((ValueError, NotImplementedError)):
        port_config(**change)


def test_init_params_layout_is_the_references():
    """The config's family's ``init_params`` (``deepseek_v3``'s) draws the
    reference's layout: the same leaves, shapes and order, the bias a float32
    buffer of zeros."""
    assert MC.family is dv3 and tq.MODEL_CONFIGS["qwen3-moe-tiny"].family is tq
    got = MC.family.init_params(MC, torch.Generator().manual_seed(0), torch.float32)
    want = weights()
    assert [(p, tuple(t.shape)) for p, t in ref.tree_leaves(got)] == \
        [(p, tuple(t.shape)) for p, t in ref.tree_leaves(want)]
    assert got["buffers"]["e_bias"].dtype == torch.float32 and not got["buffers"]["e_bias"].any()
    assert got["lm_head"].t().is_contiguous()


def test_checkpoint_keeps_the_buffers(tmp_path):
    """A checkpoint holds the routing bias beside the params; the optimizer's
    moments stay one a trained leaf."""
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    params = weights()
    trainer = Trainer(MC, EngineConfig(), TrainConfig(ckpt_dir=str(tmp_path), param_dtype="fp32"), device="cpu")
    trainer.set_params(copy.deepcopy(params))
    trainer.save()
    other = Trainer(MC, EngineConfig(), TrainConfig(ckpt_dir=str(tmp_path), param_dtype="fp32"), device="cpu")
    other.restore()
    assert torch.equal(other.params["buffers"]["e_bias"], params["buffers"]["e_bias"])
    assert len(other.opt_state["mu"]) == len(dref.trained_leaves(params))
    assert math.isclose(float(other.params["layers"]["wq"].sum()), float(params["layers"]["wq"].sum()))


# -------------------------------------------------------------- benchmark


def test_benchmark_driver_trains_and_checks_against_the_reference(monkeypatch):
    """The benchmark's entry "train_mla" (``drivers/train_mla.py``) at the
    tiny size on the CPU: the window trains through ``Trainer.train_step``,
    the traced window collects the part "moe" and the counters, and the
    checked steps are compared with the reference's (bf16 program, float32
    reference, routed as the program chose: the numbers are finite and below
    1, the routing's among them)."""
    import time

    import harness

    # the CPU has no device trace: a traced step runs untraced, with one stand-in device interval
    monkeypatch.setattr(harness, "profiled", lambda fn: (fn(), harness.Trace([("k", 0, 1)], [], (0, 2), {})))
    mix = dict(MIX, entry="train_mla", learning_rate=1e-2, grad_clip=1.0, remat=True, check_steps=2)
    cfg = dict(CFG, num_key_value_heads=4)
    limits = {"grad_diff": 1.0, "change_gap": 1.0, "route_gap": 1.0}
    cell = harness.Cell("tiny-mla", {"chips": 1}, cfg, mix, limits, [], [])
    drv = harness.load_module(harness.BENCH / "drivers" / "train_mla.py")
    for trace in (False, True):
        run = drv.run(harness.Ctx(cell, SEED, 0.0, trace, "cpu", time.perf_counter()))
        assert run.attempted > 0 and run.failed == 0 and run.e2e["train_tokens_per_s"] > 0
        assert set(run.checks) == set(limits)
        assert all(math.isfinite(v) and v < 1.0 for v, _ in run.checks.values())
    parts = run.units[-1]["parts_ms"]
    assert parts["moe.pairs"] > 0 and "moe.bias_moved" in parts


def test_flop_count_holds_the_reference_leaves():
    """``work_mla``'s active parameters a token are the reference's leaves:
    a dense layer's every matrix, a MoE layer's attention, router, shared
    experts and k of its E experts."""
    from work_mla import mla_layer_params

    specs = {p: math.prod(s) for p, s, f in dref.leaf_specs(CFG) if f not in (None, "bias")}
    dense = sum(v for p, v in specs.items() if p[0] == "dense_layers")
    moe = sum(v * (CFG["num_experts_per_tok"] / CFG["n_routed_experts"] if p[1].startswith("e_") else 1)
              for p, v in specs.items() if p[0] == "layers") / (CFG["num_hidden_layers"] - 1)
    assert mla_layer_params(CFG) == (dense, moe)
