"""A tiny Qwen3 configuration and mixes for the CPU tests: the drivers run
through the port's plain kernel versions at these sizes."""

import harness

CFG = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 128, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
       "tie_word_embeddings": True, "attention_bias": False, "rope_scaling": None, "model_type": "qwen3"}
TRAIN = {"entry": "train", "prompts_per_step": 2, "samples_per_prompt": 3, "prompt_len": [8, 16],
         "completion_len": [4, 8], "branch_prob": 0.85, "w_logprobs": -1.0, "w_entropy": 0.1, "pool": 4,
         "shape_seed": 7, "learning_rate": 1e-2, "grad_clip": 1.0, "remat": True, "check_steps": 3}
# the rollout's: large enough that one precision down moves greedy tokens
CFG_ROLLOUT = dict(CFG, hidden_size=128, intermediate_size=256, head_dim=32, vocab_size=4096, num_hidden_layers=3)
ROLLOUT = {"entry": "rollout", "prompts": 2, "group": 4, "prompt_len": [16, 32], "max_new": 48, "temperature": 1.0,
           "pool": 2, "shape_seed": 7, "check_branches": 8, "sample_branches": 8}
# limits at these sizes, between what the bf16 program reads against the
# float32 reference (seeds 5-7: loss_rel <= 1.9e-3, grad_gap <= 4.4e-3,
# grad_diff 0.015 at seed 5, change_gap <= 5.2e-3; seeds 5-10: greedy_gap
# <= 0.023, sample_z <= 1.56) and what the fp8 control reads (grad_gap >=
# 0.024, grad_diff 0.20 at seed 5; greedy_gap >= 0.36) or, for sample_z,
# which no rounding moves, the "swap" fault (>= 6.6)
TRAIN_LIMITS = {"loss_rel": 5e-3, "grad_gap": 1e-2, "grad_diff": 0.06, "change_gap": 2e-2}
ROLLOUT_LIMITS = {"greedy_gap": 0.1, "sample_z": 4.0}

def cell(mix, limits, cfg=None):
    cfg = cfg or (CFG_ROLLOUT if mix["entry"] == "rollout" else CFG)
    return harness.Cell("tiny", {"chips": 1}, dict(cfg), dict(mix), dict(limits), [], [])


def ctx(c, seed=5, seconds=0.0, trace=False):
    import time

    return harness.Ctx(c, seed, seconds, trace, "cpu", time.perf_counter())
