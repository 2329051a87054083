"""The port's Trainer against the JAX package's Trainer on one device.

CPU, fp32, the JAX training suite's TINY model (tests/test_training.py) with
its weights from the JAX Trainer's ``init`` converted through numpy, the
reference attention backend and the vocab-chunked loss on both sides, dp=1
and tp=1 for JAX. Bars: losses at rtol 1e-5 and params after the steps at
per-parameter relative error < 1e-5 (the same fp32 math in another order,
through the optax chain the port's ``OptaxAdamW`` reproduces); the
checkpoint round trip and the resumed step bit-exact (the CPU step is
deterministic).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.engine import EngineConfig as JaxEngineConfig
from dynamictreeattn_tpu.models import Qwen3Config as JaxQwen3Config
from dynamictreeattn_tpu.training import TokenBudgetBatcher as JaxTokenBudgetBatcher
from dynamictreeattn_tpu.training import TrainConfig as JaxTrainConfig
from dynamictreeattn_tpu.training import Trainer as JaxTrainer
from dynamictreeattn_tpu_torch.cli import train as cli_train
from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.models import Qwen3Config, params_from_numpy
from dynamictreeattn_tpu_torch.parallel import make_train_step, stack_batches
from dynamictreeattn_tpu_torch.training import OptaxAdamW, TokenBudgetBatcher, TrainConfig, Trainer
from dynamictreeattn_tpu_torch.utils import compare_grads

from helpers import random_trie_batch

TINY_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16, tie_word_embeddings=True)
TINY, JAX_TINY = Qwen3Config(**TINY_KW), JaxQwen3Config(**TINY_KW)
JAX_ECFG = JaxEngineConfig(block_q=32, block_kv=32, remat=False, attn_backend="reference", loss_chunk=32)
ECFG = EngineConfig(block_q=32, block_kv=32, remat=False, attn_backend="reference", loss_mode="vocab")
LOSS_RTOL, PARAM_REL = 1e-5, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [random_trie_batch(rng, n_seqs=8, vocab=TINY.vocab_size, max_len=20) for _ in range(n)]


def _port_params(tree):
    return params_from_numpy(jax.tree.map(np.asarray, jax.device_get(tree)), device="cpu")


def _pair(custom=None, extras_spec=None, ckpt_dir=None, **tc):
    """(JAX trainer, port trainer) from the same initial params."""
    jt = JaxTrainer(JAX_TINY, JAX_ECFG, JaxTrainConfig(dp=1, tp=1, learning_rate=1e-3, param_dtype="fp32", **tc),
                    custom_loss=custom and custom[0], extras_spec=extras_spec)
    jt.init(seed=0)
    pt = Trainer(TINY, ECFG, TrainConfig(learning_rate=1e-3, param_dtype="fp32", ckpt_dir=ckpt_dir, **tc),
                 custom_loss=custom and custom[1], extras_spec=extras_spec, device="cpu")
    pt.set_params(_port_params(jt.params))
    return jt, pt


def _same_params(jt, pt):
    rows = compare_grads(_port_params(jt.params), pt.params)
    assert rows[0][1] < PARAM_REL, rows[:3]


@pytest.mark.parametrize("tc", [dict(), dict(grad_clip=0.05, warmup_steps=2, weight_decay=0.1),
                                dict(grad_clip=0.05, grad_accum=2)],
                         ids=["defaults", "clip_binding_warmup_wd", "accum2"])
def test_three_steps_match_jax_trainer(tc):
    """3 train_steps on one fixed batch from the same params: equal losses,
    records with JAX's keys, equal params after (with the defaults, clip 1.0
    binds too: the tiny model's grad norm is above it); under grad_accum=2
    the first micro-step leaves the params bit-unchanged."""
    jt, pt = _pair(**tc)
    p0 = {k: v.clone() for k, v in pt.params["layers"].items()}
    for i, (seqs, attachs) in enumerate(_batches(1) * 3):
        want = jt.train_step(seqs, attachs)
        got = pt.train_step(seqs, attachs)
        assert list(got) == list(want)
        for key in ("loss", "sum_logprob", "sum_entropy"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL)
        assert {k: got[k] for k in ("step", "n_sequences", "n_tokens", "n_tree_tokens")} == \
            {k: want[k] for k in ("step", "n_sequences", "n_tokens", "n_tree_tokens")}
        if i == 0 and tc.get("grad_accum") == 2:
            assert all(torch.equal(p0[k], v) for k, v in pt.params["layers"].items())
    _same_params(jt, pt)
    assert len(pt.time_model._y) == 3 and pt.step_idx == 3


def _jax_grpo(lp, ent, extras, length):
    m = (jnp.arange(lp.shape[0]) < length - 1).astype(jnp.float32)
    ratio = jnp.exp(jnp.where(m > 0, lp - extras["beh"][: lp.shape[0]], 0.0))
    obj = jnp.minimum(ratio * extras["adv"], jnp.clip(ratio, 0.8, 1.2) * extras["adv"])
    return -jnp.sum(obj * m) / jnp.maximum(length - 1, 1)


def _torch_grpo(lp, ent, extras, length):
    m = (torch.arange(lp.shape[0]) < length - 1).float()
    ratio = torch.exp(torch.where(m > 0, lp - extras["beh"][: lp.shape[0]], 0.0))
    obj = torch.minimum(ratio * extras["adv"], torch.clamp(ratio, 0.8, 1.2) * extras["adv"])
    return -torch.sum(obj * m) / torch.clamp(length - 1, min=1)


def test_grpo_custom_loss_matches_jax_trainer():
    """The clipped-ratio GRPO loss through custom_loss / extras_spec
    {"beh": 1, "adv": 0}: behavior log-probs from forward_logprobs (equal
    to JAX's), then 3 steps with equal losses, aux sums and params."""
    jt, pt = _pair(custom=(_jax_grpo, _torch_grpo), extras_spec={"beh": 1, "adv": 0})
    seqs, attachs = _batches(1, seed=4)[0]
    beh, want_beh = pt.forward_logprobs(seqs, attachs), jt.forward_logprobs(seqs, attachs)
    for a, b in zip(beh, want_beh):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    adv = np.random.default_rng(3).normal(size=len(seqs)).astype(np.float32)
    for _ in range(3):
        want = jt.train_step(seqs, attachs, extras={"beh": want_beh, "adv": adv})
        got = pt.train_step(seqs, attachs, extras={"beh": want_beh, "adv": adv})
        for key in ("loss", "sum_logprob", "sum_entropy"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, atol=1e-6)
    _same_params(jt, pt)


def test_forward_logprobs_and_binning_match_jax():
    """forward_logprobs (aligned with the input order) and
    partition_with_ids(n_bins=3) (host binning on one device) equal JAX's."""
    jt, pt = _pair()
    seqs, attachs = _batches(1, seed=6)[0]
    for a, b in zip(pt.forward_logprobs(seqs, attachs), jt.forward_logprobs(seqs, attachs)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    for n_bins in (1, 3):
        tries, bins = pt.partition_with_ids(seqs, attachs, n_bins=n_bins)
        jtries, jbins = jt.partition_with_ids(seqs, attachs, n_bins=n_bins)
        assert bins == jbins
        assert [t.n_tree_tokens for t in tries] == [t.n_tree_tokens for t in jtries]


def test_greedy_rollout_matches_jax():
    jt, pt = _pair()
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, TINY.vocab_size, size=(2, 8)).astype(np.int32)
    lens = np.array([8, 6], np.int32)
    np.testing.assert_array_equal(pt.rollout(prompts, lens, group=3, max_new=5, greedy=True),
                                  np.asarray(jt.rollout(prompts, lens, group=3, max_new=5, greedy=True)))


def _state_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    if a is None:
        return b is None
    return torch.equal(a, b)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return None if tree is None else tree.clone()


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_nonfinite_loss_leaves_state_unchanged(grad_accum):
    """A planted NaN loss weight: the step is recorded as skipped and params,
    moments and the accumulation state stay bit-unchanged."""
    _, pt = _pair(grad_accum=grad_accum)
    batches = _batches(2, seed=8)
    pt.train_step(*batches[0])
    params, state = _clone(pt.params), _clone(pt.opt_state)
    seqs, attachs = batches[1]
    attachs = [dict(a) for a in attachs]
    attachs[0]["w_logprobs"] = float("nan")
    rec = pt.train_step(seqs, attachs)
    assert rec["skipped"] and not np.isfinite(rec["loss"]) and pt.skipped_steps == 1
    assert _state_equal(pt.params, params) and _state_equal(pt.opt_state, state)
    assert len(pt.time_model._y) == 1


def test_checkpoint_round_trip_and_resumed_step(tmp_path):
    """save -> a new trainer's restore: params, optimizer state and step_idx
    equal; the restored trainer's next step equals the original's, bitwise."""
    _, pt = _pair(ckpt_dir=str(tmp_path / "ck"), warmup_steps=3, grad_accum=2)
    batches = _batches(4, seed=9)
    for b in batches[:3]:
        pt.train_step(*b)
    pt.save()
    pt2 = Trainer(TINY, ECFG, pt.tc, device="cpu")
    pt2.restore()
    assert pt2.step_idx == 3
    assert _state_equal(pt2.params, pt.params) and _state_equal(pt2.opt_state, pt.opt_state)
    a, b = pt.train_step(*batches[3]), pt2.train_step(*batches[3])
    assert a["loss"] == b["loss"] and _state_equal(pt2.params, pt.params)
    assert _state_equal(pt2.opt_state, pt.opt_state)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    from dynamictreeattn_tpu_torch.training import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (1, 5, 3, 7):
        mgr.save(step, {"w": torch.full((2,), float(step))}, extra={"step": step})
    assert mgr.steps() == [5, 7] and mgr.latest_step() == 7
    assert float(mgr.restore(5)["params"]["w"][0]) == 5.0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    mgr.close()


def test_token_budget_batcher_matches_jax():
    rng = np.random.default_rng(2)
    stream = [random_trie_batch(rng, n_seqs=4, vocab=64, max_len=16) for _ in range(6)]
    for budget in (40, 120, 10_000):
        got = list(TokenBudgetBatcher(budget)(stream))
        want = list(JaxTokenBudgetBatcher(budget)(stream))
        assert [[s.tolist() for s in seqs] for seqs, _ in got] == [[s.tolist() for s in seqs] for seqs, _ in want]
        assert [a for _, a in got] == [a for _, a in want]


CLI = ["--device", "cpu", "--model", "qwen3-tiny", "--dtype", "fp32", "--attn-backend", "reference",
       "--block-q", "32", "--block-kv", "32", "--lr", "1e-3", "--warmup-steps", "2",
       "--data", "synthetic:n_prompts=1,samples=3,prompt_lo=8,prompt_hi=12,completion_lo=4,completion_hi=8"]


def test_cli_train_resume_equals_uninterrupted(tmp_path, capsys):
    """cli.train: 2 steps with --ckpt-dir / --ckpt-every, then --resume for
    1 step, ends bit-equal (params, optimizer state, step) to 3 steps in one
    run."""
    cli_train.main(CLI + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "2"])
    resumed = cli_train.main(CLI + ["--steps", "1", "--ckpt-dir", str(tmp_path / "a"), "--resume"])
    whole = cli_train.main(CLI + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and out.count("saved checkpoint at step 3") == 2
    assert resumed.step_idx == whole.step_idx == 3
    assert _state_equal(resumed.params, whole.params) and _state_equal(resumed.opt_state, whole.opt_state)


@pytest.mark.parametrize("kw", [dict(dp=2), dict(tp=2), dict(sp=2), dict(pp=2), dict(fsdp=True),
                                dict(ep=True), dict(multihost=True)])
def test_multi_device_settings_raise(kw):
    """The settings still to port raise naming ROADMAP item 10; dp and tp
    above 1 need the ranks' process group (tests/test_torch_dist_trainer.py
    runs them), and ep a MoE model."""
    match = {"dp": "not initialised", "tp": "not initialised", "ep": "MoE"}.get(next(iter(kw)), "item 10")
    with pytest.raises(ValueError, match=match):
        Trainer(TINY, ECFG, TrainConfig(**kw), device="cpu")


def test_multi_device_steps_raise():
    from dynamictreeattn_tpu_torch.parallel import Mesh

    tries = [t for t in _batches(1)]
    with pytest.raises(ValueError, match="item 10"):
        make_train_step(TINY, ECFG, device="cpu", sp=2)
    with pytest.raises(ValueError, match="item 10"):
        stack_batches([], ECFG, sp=2)
    mesh = Mesh({"data": 2, "seq": 1, "pipe": 1, "model": 1}, {"data": 0, "seq": 0, "pipe": 0, "model": 0}, {},
                "gloo", torch.device("cpu"), None)
    with pytest.raises(ValueError, match="a mesh of"):  # a mesh that is not the config's dp x tp
        Trainer(TINY, ECFG, TrainConfig(), mesh=mesh, device="cpu")
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    two = stack_batches([TokenTrie(s, a) for s, a in tries * 2], ECFG)
    assert two.dp == 2 and len({p.n_padded for p in two.packeds}) == 1
    with pytest.raises(ValueError, match="needs a step over a mesh"):
        make_train_step(TINY, ECFG, device="cpu")(_pair()[1].params, two)


def test_optimizer_is_not_clip_grad_norm():
    """The clip scales by max_norm / norm (optax), not max_norm / (norm +
    1e-6) (torch.nn.utils.clip_grad_norm_)."""
    g = {"w": torch.tensor([3.0, 4.0])}
    opt = OptaxAdamW(1.0, grad_clip=1.0)
    seen = {}
    p = {"w": torch.zeros(2)}
    opt.update(g, opt.init(p), p, torch.tensor(True), mark=lambda name: seen.setdefault(name, g["w"].clone()))
    torch.testing.assert_close(seen["clip"], torch.tensor([3.0, 4.0]) / 5.0, rtol=0, atol=0)


def test_port_modules_import_without_jax():
    """Every module of the port (and chip_smoke.py) imports with jax and the
    JAX package blocked."""
    code = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "dynamictreeattn_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import dynamictreeattn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    pkg = os.path.join(REPO, "dynamictreeattn_tpu_torch")
    files = sum(f.endswith(".py") for _, _, fs in os.walk(pkg) for f in fs)
    assert int(out.stdout.split()[-1]) == files - 1  # the top package itself is not walked


@pytest.mark.parametrize("loss", ["linear", "grpo"])
def test_moe_trainer_matches_jax_trainer(loss):
    """qwen3-moe-tiny at dp = 1: 3 steps of the linear loss and of the GRPO
    custom loss, both with the router's load-balance term (JAX
    ``make_train_step`` adds it to either), equal losses and params; the
    JAX engine pads to "exact" buckets, the port's length."""
    from dynamictreeattn_tpu.models import MODEL_CONFIGS as JAX_CONFIGS
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS

    custom, spec = ((_jax_grpo, _torch_grpo), {"beh": 1, "adv": 0}) if loss == "grpo" else ((None, None), None)
    jt = JaxTrainer(JAX_CONFIGS["qwen3-moe-tiny"], dataclasses.replace(JAX_ECFG, bucketing="exact"),
                    JaxTrainConfig(dp=1, tp=1, learning_rate=1e-3, param_dtype="fp32"),
                    custom_loss=custom[0], extras_spec=spec)
    jt.init(seed=0)
    pt = Trainer(MODEL_CONFIGS["qwen3-moe-tiny"], ECFG, TrainConfig(learning_rate=1e-3, param_dtype="fp32"),
                 custom_loss=custom[1], extras_spec=spec, device="cpu")
    pt.set_params(_port_params(jt.params))
    seqs, attachs = _batches(1, seed=8)[0]
    extras = None
    if loss == "grpo":
        extras = {"beh": jt.forward_logprobs(seqs, attachs),
                  "adv": np.random.default_rng(3).normal(size=len(seqs)).astype(np.float32)}
    for _ in range(3):
        want = jt.train_step(seqs, attachs, extras=extras)
        got = pt.train_step(seqs, attachs, extras=extras)
        for key in ("loss", "sum_logprob", "sum_entropy"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, atol=1e-6)
    _same_params(jt, pt)
