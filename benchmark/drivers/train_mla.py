"""Entry "train_mla": ``Trainer.train_step(seqs, attachs)`` once per step, as
entry "train" (``train.py``), for a DeepSeek-V3 configuration (HF
``model_type: deepseek_v3``): the port's ``DeepseekV3Config`` (MLA, the
sigmoid-routed MoE with shared experts, leading dense layers) built from the
configuration's file, its weights and the reference's checked steps from
``reference/deepseek_v3.py``. The window and the traced steps are
``train.py``'s own (``run``); the routing bias is read and not trained, so
it has no gradient, moment or change to compare.

The reference routes each checked step's rows to the experts the program
chose (``program_checks`` records them from ``deepseek_v3.route``), so
that the numbers ``check.py`` compares measure the arithmetic and not the
bf16 router's flips at near-ties, each of which sends a row through other
experts and reorders two experts' capacity ranks. The choices themselves
are compared as ``route_gap``: the largest amount by which a chosen
expert's selection value (sigmoid + bias), in the reference's float32,
lies below the row's k-th largest; ``route_flips``, the share of chosen
pairs off the reference's own top-k, is printed and not compared.
"""

from __future__ import annotations

import contextlib
import types

import torch

import check
import generator
import harness
from reference import deepseek_v3 as ref

base = harness.load_module(harness.BENCH / "drivers" / "train.py")


def port_config(cfg: dict):
    """The port's ``DeepseekV3Config`` of a configuration file; what the
    port does not compute (a q LoRA, grouped routing, rope scaling) is
    refused."""
    from dynamictreeattn_tpu_torch.models.deepseek_v3 import DeepseekV3Config

    if cfg.get("q_lora_rank") is not None or cfg.get("rope_scaling") is not None:
        raise ValueError("q LoRA and rope scaling are not mapped")
    if (cfg["topk_method"], cfg["n_group"], cfg["topk_group"]) != ("noaux_tc", 1, 1):
        raise ValueError("only noaux_tc routing with one group is mapped")
    assumed = cfg["assumed"]
    return DeepseekV3Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"], num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"], head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
        tie_word_embeddings=cfg["tie_word_embeddings"], attention_bias=cfg["attention_bias"],
        num_experts=cfg["n_routed_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
        moe_intermediate_size=cfg["moe_intermediate_size"], norm_topk_prob=cfg["norm_topk_prob"],
        router_aux_coef=assumed["router_aux_coef"], moe_capacity_factor=assumed["moe_capacity_factor"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        n_shared_experts=cfg["n_shared_experts"], first_k_dense_replace=cfg["first_k_dense_replace"],
        scoring_func=cfg["scoring_func"], routed_scaling_factor=cfg["routed_scaling_factor"])


def start(ctx: harness.Ctx):
    """(trainer, pool, trained leaf paths), as ``train.start``."""
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg, mix = ctx.cfg, ctx.mix
    mc = port_config(cfg)  # first: a program without the family fails here, before any weight is drawn
    pool = generator.train_pool(mix, cfg["vocab_size"], ctx.seed)
    weights = ref.make_weights(cfg, ctx.seed, ctx.device)
    trainer = Trainer(mc, EngineConfig(remat=mix["remat"]),
                      TrainConfig(learning_rate=mix["learning_rate"], grad_clip=mix["grad_clip"]), device=ctx.device)
    trainer.set_params(weights)
    return trainer, pool, [p for p, _ in ref.trained_leaves(weights)]


@contextlib.contextmanager
def recorded_routes(log: list):
    """Appends every ``deepseek_v3.route`` call's idx (on the host) to `log`."""
    from dynamictreeattn_tpu_torch.models import deepseek_v3

    orig = deepseek_v3.route

    def recording(*args, **kw):
        w, idx, lb = orig(*args, **kw)
        log.append(idx.detach().cpu())
        return w, idx, lb

    deepseek_v3.route = recording
    try:
        yield
    finally:
        deepseek_v3.route = orig


def program_checks(trainer, pool, k, ctx, paths) -> dict:
    """``train.program_checks`` over the trained leaves, with each step's
    routing ("routes" [step][MoE layer] idx [rows, k]: the forward's, the
    first of a step's calls; the recompute's repeat them)."""
    out = {"loss": [], "routes": []}
    layers = ctx.cfg["num_hidden_layers"] - ctx.cfg["first_k_dense_replace"]
    for i in range(k):
        calls = []
        with recorded_routes(calls):
            rec = trainer.train_step(*pool[i])
        out["routes"].append(calls[:layers])
        out["loss"].append(rec["loss"])
        if i == 0:
            out["grad_norm"] = {".".join(p): float(torch.linalg.vector_norm(m.float())) / (1 - base.B1)
                                for p, m in zip(paths, trainer.opt_state["mu"])}
            out["first_grad"] = [m.to("cpu", copy=True) for m in trainer.opt_state["mu"]]
            out["first_grad_scale"] = 1 / (1 - base.B1)
    now = dict(ref.trained_leaves(trainer.params))
    out["change_norm"] = {".".join(p): float(torch.linalg.vector_norm(
        now[p].float() - ref.make_leaf(ctx.cfg, ctx.seed, p, ctx.device).float())) for p in paths}
    return out


def reference(ctx: harness.Ctx, pool, precision: str = "fp32", against=None, keep_first=False,
              route_log=None) -> dict:
    """The reference's (or, at "fp8", the control's) checked steps, as
    ``train.reference``, routed as the one side of `against` was (its
    "routes"; no side, its own top-k)."""
    others = {name: (side["first_grad"], side["first_grad_scale"]) for name, side in (against or {}).items()}
    if len(others) > 1:
        raise ValueError("the reference follows one side's routing: judge one side a run")
    forced = next((side["routes"] for side in (against or {}).values()), None)
    return ref.train_steps(ctx.cfg, lambda: ref.make_weights(ctx.cfg, ctx.seed, ctx.device),
                           pool[:ctx.mix["check_steps"]], ctx.mix["learning_rate"], ctx.mix["grad_clip"], precision,
                           others, keep_first, route_log, forced)


def train_numbers(program: dict, reference: dict, name: str = "program") -> dict:
    """``check.train_numbers`` and the routing's numbers of a side whose
    routing the reference followed."""
    return dict(check.train_numbers(program, reference, name), route_gap=reference["route_gap"],
                route_flips=reference["route_flips"])


def bias_share(route_log: list) -> str:
    """The reference's first step's share of (row, choice) pairs that the
    routing bias moved off the bias-free top-k: over all layers, and each layer's."""
    total = sum(r["bias_moved"] for r in route_log) / sum(r["pairs"] for r in route_log)
    layers = ", ".join("%.1f" % (100 * r["bias_moved"] / r["pairs"]) for r in route_log)
    return f"{100 * total:.2f}% ({layers})"


def run(ctx: harness.Ctx) -> harness.Run:
    """``train.run`` on this family: this module's private copy of
    ``train.py`` (``base``) runs its window and checks with the functions
    above in place of its own ``start``, ``program_checks`` and
    ``reference``, and ``check`` with ``train_numbers`` above."""
    base.start, base.program_checks, base.reference = start, program_checks, reference
    base.check = types.SimpleNamespace(train_numbers=train_numbers, moving=check.moving)
    return base.run(ctx)
