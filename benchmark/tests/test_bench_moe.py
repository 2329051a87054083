"""The reference's MoE block keeps the pairs the configuration's capacity
dispatch keeps: its rows are the trie's tokens in the order the program
routes them, and at float32 its first step's loss is the port's to
rounding, with capacity to spare and with most pairs dropped."""

import math

import numpy as np
import pytest
import torch

import generator
import harness
import tiny
from reference import model as ref
from reference.weights import make_weights

MIX = dict(tiny.TRAIN, prompts_per_step=3, samples_per_prompt=6, prompt_len=[20, 40], completion_len=[8, 20])


def moe_cfg(factor):
    return dict(tiny.CFG, tie_word_embeddings=False, num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                norm_topk_prob=True, router_aux_loss_coef=0.001, assumed={"moe_capacity_factor": factor})


def test_trie_rows_are_the_ports_order():
    from dynamictreeattn_tpu_torch.tries import TokenTrie, flatten_trie

    for seqs, _ in generator.train_pool(MIX, 128, seed=3):
        rows, n = ref.trie_rows(seqs)
        packed = flatten_trie(TokenTrie(list(seqs), [{} for _ in seqs]))
        assert n == packed.n_tokens
        for s, r in zip(seqs, rows):
            assert np.array_equal(packed.tokens[r], s)


@pytest.mark.parametrize("factor", [1.5, 0.5])
def test_first_step_loss_is_the_ports(factor):
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = moe_cfg(factor)
    pool = generator.train_pool(MIX, cfg["vocab_size"], 5)
    trainer = Trainer(harness.port_config(cfg), EngineConfig(),
                      TrainConfig(learning_rate=1e-2, grad_clip=1.0, param_dtype="fp32"), device="cpu")
    trainer.set_params(make_weights(cfg, 5, "cpu", torch.float32))
    loss = trainer.train_step(*pool[0])["loss"]
    want = ref.train_steps(cfg, lambda: make_weights(cfg, 5, "cpu", torch.float32), pool[:1], 1e-2, 1.0)["loss"][0]
    assert abs(loss - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("factor", [1.5, 0.5])
def test_routing_is_the_ports_at_float32(factor):
    """``calibrate.py``'s routing readings: at float32 the program's first
    routing is the reference's, row for row, and the reference counts the
    pairs the capacity dispatch drops."""
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    cal = harness.load_module(harness.BENCH / "calibrate.py")
    drv = harness.load_module(harness.BENCH / "drivers" / "train.py")
    cfg = moe_cfg(factor)
    pool = generator.train_pool(MIX, cfg["vocab_size"], 5)
    program, reference = [], []
    with cal.program_routes(program, cfg["num_hidden_layers"]):
        trainer = Trainer(harness.port_config(cfg), EngineConfig(),
                          TrainConfig(learning_rate=1e-2, grad_clip=1.0, param_dtype="fp32"), device="cpu")
        trainer.set_params(make_weights(cfg, 5, "cpu", torch.float32))
        trainer.train_step(*pool[0])
    ref.train_steps(cfg, lambda: make_weights(cfg, 5, "cpu", torch.float32), pool[:1], 1e-2, 1.0, route_log=reference)
    flips = cal.route_flips(program, reference, cfg["num_experts_per_tok"])
    assert len(flips) == cfg["num_hidden_layers"] and all(f["rows"] == 0 and f["pairs"] == 0 for f in flips), flips
    n_pad = -(-reference[0]["idx"].shape[0] // ref.PAD_ROWS) * ref.PAD_ROWS
    kept_max = cfg["num_experts"] * math.ceil(factor * n_pad * cfg["num_experts_per_tok"] / cfg["num_experts"])
    for r in reference:  # no expert keeps more than its capacity
        assert 0 <= r["pairs"] - r["dropped"] <= kept_max, drv.drop_share(reference)
