"""The port's HF bridge (``models/hf_compat.py``) against the JAX package's
and against HF transformers / safetensors.

CPU; tiny configs of the four families the bridge names (Qwen3, Qwen2.5 —
q/k/v bias, no q/k norm —, Llama, Qwen3-MoE), tied and untied. Checks:
``to_hf_state_dict`` equals the JAX package's key for key and value for
value (exactly: both are the same fp32 numbers, transposed), and
``from_hf_state_dict`` inverts it onto the JAX layout; the port's own
safetensors reader equals ``safetensors.torch.load_file`` bit for bit on
files that ``safetensors.torch.save_file`` wrote (bf16, fp16, fp32, one
file and sharded); ``load_hf_checkpoint`` on such a directory gives the
params written, bit for bit, in the dtype asked; ``cli.run --ckpt`` equals
the run from the same weights in memory; the MoE forward equals HF
``Qwen3MoeForCausalLM`` at 2e-4 (JAX ``test_moe_logits_match_hf``).
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.models.hf_compat import from_hf_state_dict as jax_from_hf
from dynamictreeattn_tpu.models.hf_compat import to_hf_state_dict as jax_to_hf
from dynamictreeattn_tpu_torch.cli import run
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params, params_from_numpy
from dynamictreeattn_tpu_torch.models import qwen3 as tq
from dynamictreeattn_tpu_torch.models.hf_compat import (
    from_hf_state_dict, hf_config, load_hf_checkpoint, read_safetensors, to_hf_state_dict,
)
from dynamictreeattn_tpu_torch.ops import tree_attention_reference
from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

HF_TOL = 2e-4
FAMILIES = {"qwen3": ("qwen3-tiny", {}), "qwen2.5": ("qwen3-tiny", dict(use_qk_norm=False, attention_bias=True)),
            "llama": ("llama-tiny", {}), "moe": ("qwen3-moe-tiny", {})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(family, tie=True):
    name, kw = FAMILIES[family]
    kw = dict(kw, tie_word_embeddings=tie)
    return dataclasses.replace(jq.MODEL_CONFIGS[name], **kw), dataclasses.replace(MODEL_CONFIGS[name], **kw)


def _same_params(a, b):
    la, lb = sorted(named_leaves(a), key=lambda x: x[0]), sorted(named_leaves(b), key=lambda x: x[0])
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dicts_match_jax(family, tie):
    """to_hf_state_dict == JAX's key for key (names, order, values); both
    from_hf_state_dicts rebuild the params; the port's head comes back as a
    [d, V] view of [V, d] storage."""
    jc, c = _configs(family, tie)
    jp = jq.init_params(jc, jax.random.key(1), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want, got = jax_to_hf(jp, jc), to_hf_state_dict(tp, c)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    back = from_hf_state_dict(got, c, torch.float32, "cpu")
    _same_params(back, tp)
    init = init_params(c, torch.Generator().manual_seed(0), torch.float32)
    assert list(back) == list(init) and list(back["layers"]) == list(init["layers"])
    _same_params(from_hf_state_dict(want, c, torch.float32, "cpu"),
                 params_from_numpy(jax.tree.map(np.asarray, jax_from_hf(want, jc, jnp.float32)), device="cpu"))
    if not tie:
        assert back["lm_head"].stride() == (1, c.hidden_size)


def _write_shards(sd: dict, path, n_shards: int) -> None:
    """HF names -> `n_shards` safetensors files (a tied head left out, as HF
    saves it), the tensors dealt round-robin."""
    path.mkdir(parents=True, exist_ok=True)
    names = [k for k in sd if not (k == "lm_head.weight" and sd[k] is sd["model.embed_tokens.weight"])]
    for s in range(n_shards):
        part = {k: sd[k].contiguous() for k in names[s::n_shards]}
        save_file(part, str(path / f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"))


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
def test_reader_and_loader_match_safetensors(tmp_path, dtype, tie):
    """The port's reader equals safetensors.torch.load_file on every shard;
    load_hf_checkpoint gives the written params bit for bit in their dtype,
    and in fp32 their exact fp32 values."""
    _, c = _configs("moe", tie)
    params = init_params(c, torch.Generator().manual_seed(2), dtype)
    _write_shards(to_hf_state_dict(params, c), tmp_path, 3)
    for f in sorted(tmp_path.glob("*.safetensors")):
        want = load_file(str(f))
        got = {name: read() for name, read in read_safetensors(str(f)).items()}
        assert list(got) == list(want)
        for name in want:
            assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name
    _same_params(load_hf_checkpoint(str(tmp_path), c, dtype, "cpu"), params)
    as_fp32 = load_hf_checkpoint(str(tmp_path), c, torch.float32, "cpu")
    _same_params(as_fp32, {k: ({n: t.float() for n, t in v.items()} if k == "layers" else v.float())
                           for k, v in params.items()})


def test_reader_refusals(tmp_path):
    save_file({"x": torch.zeros(3, dtype=torch.int32)}, str(tmp_path / "a.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        read_safetensors(str(tmp_path / "a.safetensors"))
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        load_hf_checkpoint(str(tmp_path / "missing"), MODEL_CONFIGS["qwen3-tiny"], device="cpu")


def test_reader_names_the_truncated_tensor(tmp_path):
    """A shard cut short inside the second tensor's bytes: reading it or
    any tensor stored after it raises naming that tensor; the first still
    reads."""
    f = tmp_path / "a.safetensors"
    save_file({name: torch.full((8,), float(i)) for i, name in enumerate("abc")}, str(f))
    raw = f.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = {k: v for k, v in json.loads(raw[8:8 + n]).items() if k != "__metadata__"}
    stored = sorted(header, key=lambda k: header[k]["data_offsets"][0])
    f.write_bytes(raw[:8 + n + header[stored[1]]["data_offsets"][0] + 2])
    readers = read_safetensors(str(f))
    assert torch.equal(readers[stored[0]](), torch.full((8,), float("abc".index(stored[0]))))
    for name in stored[1:]:
        with pytest.raises(ValueError, match=f"truncated at {name}$"):
            readers[name]()


@pytest.mark.parametrize("model", ["qwen3-tiny", "qwen3-moe-tiny"])
def test_cli_run_ckpt_equals_the_weights_in_memory(tmp_path, capsys, model):
    """cli.run --ckpt DIR (HF shards of the weights --seed 0 draws) prints
    the record of the run on those weights in memory."""
    c = MODEL_CONFIGS[model]
    params = init_params(c, torch.Generator(device="cpu").manual_seed(0), torch.float32)
    _write_shards(to_hf_state_dict(params, c), tmp_path / "ckpt", 2)
    argv = ["--model", model, "--dtype", "fp32", "--attn-backend", "reference", "--block-q", "32",
            "--block-kv", "32", "--no-remat", "--iters", "1", "--device", "cpu", "--run", "tree_backward",
            "--data", "synthetic:n_prompts=1,samples=3,prompt_lo=8,prompt_hi=12,completion_lo=4,completion_hi=8"]
    records = []
    for extra in ([], ["--ckpt", str(tmp_path / "ckpt"), "--seed", "5"]):
        run.main(argv + extra)
        records.append(json.loads([x for x in capsys.readouterr().out.splitlines() if x.startswith("{")][-1]))
    for key in ("loss", "sum_logprob", "sum_entropy", "grad_norm"):
        assert records[0][key] == records[1][key], key


def test_moe_logits_match_hf():
    """The port's MoE forward == HF Qwen3MoeForCausalLM on the same weights
    through the port's bridge; HF computes the experts exactly, so the port
    runs at capacity factor E."""
    from transformers.models.qwen3_moe import Qwen3MoeForCausalLM

    c = dataclasses.replace(MODEL_CONFIGS["qwen3-moe-tiny"], moe_capacity_factor=8.0)
    params = init_params(c, torch.Generator().manual_seed(0), torch.float32)
    n = 24
    tokens = torch.from_numpy(np.array([3, 7, 11, 2, 9] * 5, np.int32)[:n])
    chain = torch.full((n,), n - 1, dtype=torch.int32)
    hidden = tq.forward_hidden(params, c, tokens, torch.arange(n, dtype=torch.int32),
                               lambda q, k, v: tree_attention_reference(q, k, v, chain))
    ours = tq.logits_from_hidden(params, c, hidden)
    hf = Qwen3MoeForCausalLM(hf_config(c)).eval()
    missing, unexpected = hf.load_state_dict(to_hf_state_dict(params, c), strict=False)
    assert not [m for m in missing if "rotary" not in m], missing
    assert not unexpected, unexpected
    with torch.no_grad():
        theirs = hf(tokens[None].long()).logits[0]
    np.testing.assert_allclose(ours.numpy(), theirs.float().numpy(), rtol=HF_TOL, atol=HF_TOL)
