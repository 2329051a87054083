"""Sequence batch IO.

Counterpart of ``dynamictreeattn_tpu/data/io.py``: reads torch ``.pt`` files
holding a list of LongTensors (the reference prototype's format) and
``.npz`` files, and builds ``synthetic:`` generator specs; writes either
format.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamictreeattn_tpu_torch.data.synthetic import synthetic_rollout_batch

__all__ = ["load_sequences", "save_sequences", "parse_data_spec"]


def load_sequences(path: str) -> list[np.ndarray]:
    if path.endswith(".pt"):
        # a list of tensors written by save_sequences or the reference
        # prototype: not plain tensors only, so the full unpickler
        seqs = torch.load(path, map_location="cpu", weights_only=False)
        return [np.asarray(s, dtype=np.int32).reshape(-1) for s in seqs]
    if path.endswith(".npz"):
        with np.load(path) as z:
            return [z[k].astype(np.int32) for k in sorted(z.files, key=_numkey)]
    raise ValueError(f"unsupported data file {path!r} (.pt or .npz)")


def _numkey(k: str):
    try:
        return (0, int(k.split("_")[-1]))
    except ValueError:
        return (1, k)


def save_sequences(path: str, seqs) -> None:
    if path.endswith(".pt"):
        torch.save([torch.as_tensor(np.asarray(s), dtype=torch.long) for s in seqs], path)
    elif path.endswith(".npz"):
        np.savez(path, **{f"seq_{i}": np.asarray(s, np.int32) for i, s in enumerate(seqs)})
    else:
        raise ValueError(f"unsupported data file {path!r}")


def parse_data_spec(spec: str, vocab_size: int):
    """(seqs, attachs) from a data path (.pt/.npz) or a
    ``synthetic:key=val,key=val`` generator spec (keys: seed, n_prompts,
    samples, prompt_lo/hi, completion_lo/hi, branch_prob)."""
    if not spec.startswith("synthetic:"):
        seqs = load_sequences(spec)
        return seqs, [{} for _ in seqs]
    kv = {}
    for part in filter(None, spec[len("synthetic:"):].split(",")):
        k, v = part.split("=")
        kv[k] = float(v) if "." in v else int(v)
    return synthetic_rollout_batch(
        seed=int(kv.get("seed", 0)),
        n_prompts=int(kv.get("n_prompts", 2)),
        samples_per_prompt=int(kv.get("samples", 8)),
        prompt_len=(int(kv.get("prompt_lo", 512)), int(kv.get("prompt_hi", 1024))),
        completion_len=(int(kv.get("completion_lo", 128)), int(kv.get("completion_hi", 512))),
        branch_prob=float(kv.get("branch_prob", 0.7)),
        vocab_size=vocab_size,
    )
