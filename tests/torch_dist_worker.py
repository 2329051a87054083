"""The ranks of the port's multi-rank tests: one fresh process per rank, over
gloo on the CPU.

A test file spawns its ranks once (a module-scoped fixture calling
``run_ranks``) and every rank runs all of the file's cases in order, each
a ``case_<name>`` function below called with the case's keyword arguments
(numpy inputs made by the test from a seed); what a case returns is written
as ``<case>.<rank>.npz`` for the test to compare with the JAX package. The
ranks rendezvous through a ``FileStore`` in the test's temporary directory
(no TCP port: parallel test workers would collide) and run one intra-op
thread each. This module imports neither ``jax`` nor the JAX package, and
the ranks check that neither was imported; pytest does not collect it.

Run by hand: ``python tests/torch_dist_worker.py RANK WORLD DIR`` with
``DIR/cases.pkl`` holding [(case name, function name, kwargs), ...].
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.models import Qwen3Config, params_from_numpy
from dynamictreeattn_tpu_torch.parallel import (
    gather_params, global_sum_squares, make_forward_step, make_mesh, make_train_step, shard_params, stack_batches,
    tp_model,
)
from dynamictreeattn_tpu_torch.training import OptaxAdamW, TrainConfig, Trainer
from dynamictreeattn_tpu_torch.tries import TokenTrie

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(world: int, cases: list, workdir: str, timeout: float = 240.0) -> dict:
    """Spawn `world` ranks running `cases`; {case name: [rank 0's dict or
    None, rank 1's, ...]}. Raises with the ranks' output if one fails."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    logs = [open(os.path.join(workdir, f"log.{r}.txt"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), workdir],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"log.{r}.txt")) as f:
                out.append(f"--- rank {r} (exit {procs[r].returncode}):\n{f.read()[-4000:]}")
        raise RuntimeError("a rank failed or timed out\n" + "\n".join(out))
    results = {}
    for name, _, _ in cases:
        results[name] = []
        for r in range(world):
            path = os.path.join(workdir, f"{name}.{r}.npz")
            results[name].append(dict(np.load(path)) if os.path.exists(path) else None)
    return results


# --------------------------------------------------------------------- ranks

def _named(tree, prefix: str) -> dict:
    """{prefix + "layers/wq": fp32 numpy, ...} of a nested dict of tensors."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_named(val, prefix + key + "/"))
        else:
            out[prefix + key] = val.detach().float().numpy().copy()  # not a view of a param updated in place
    return out


def _common(cfg, ecfg, params, dp, tp):
    mc, ec = Qwen3Config(**cfg), EngineConfig(**ecfg)
    mesh = make_mesh(dp=dp, tp=tp, backend="gloo", device="cpu")
    return mc, ec, mesh, None if params is None else params_from_numpy(params, device="cpu")


def _lead():
    return dist.get_rank() == 0


def case_vp(tp, temperature, hidden, w, tokens, parent, w_lp, w_ent, modes):
    """vp_position_stats and the vp loss's grads (hidden through mpar_in,
    as forward_hidden_tp leaves it) per loss mode on a tp-rank mesh."""
    from dynamictreeattn_tpu_torch.parallel.collectives import all_gather_dim, mpar_in
    from dynamictreeattn_tpu_torch.parallel.vocab_parallel import vp_position_stats, vp_tree_loss_from_hidden

    mesh = make_mesh(dp=1, tp=tp, backend="gloo", device="cpu")
    if mesh is None:
        return None
    v_l = w.shape[1] // tp
    r = mesh.rank("model")
    # the shard as the kernels take it: a [d, V/tp] view of [V/tp, d] rows
    w_local = torch.from_numpy(np.ascontiguousarray(w[:, r * v_l:(r + 1) * v_l].T)).t()
    h0 = torch.from_numpy(hidden)
    t = {k: torch.from_numpy(v) for k, v in (("tokens", tokens), ("parent", parent), ("w_lp", w_lp),
                                             ("w_ent", w_ent))}
    out = {}
    for mode in modes:
        lse, ent = vp_position_stats(h0, w_local, temperature, 16, mesh, mode=mode)
        h = h0.clone().requires_grad_(True)
        wl = w_local.detach().clone().requires_grad_(True)
        loss, _ = vp_tree_loss_from_hidden(mpar_in(h, mesh.group("model")), wl, t["tokens"], t["parent"], t["w_lp"],
                                           t["w_ent"], temperature, 16, mesh, mode=mode)
        gh, gw = torch.autograd.grad(loss, (h, wl))
        out.update({f"lse_{mode}": lse.numpy(), f"ent_{mode}": ent.numpy(), f"loss_{mode}": loss.detach().numpy(),
                    f"gh_{mode}": gh.numpy(), f"gw_{mode}": all_gather_dim(gw, mesh.group("model"), 1).numpy()})
    return out


def case_step(dp, tp, cfg, ecfg, params, tries, ep=False, record_routes=False):
    """make_train_step on the mesh: the loss and aux on every rank, rank 0
    the grads gathered whole; with `record_routes`, each MoE layer's routing
    and the dropped pairs of its all-to-all dispatch."""
    mc, ec, mesh, full = _common(cfg, ecfg, params, dp, tp)
    if mesh is None:
        return None
    ep_size = dp if ep else 1
    step = make_train_step(mc, ec, mesh=mesh, ep=ep)
    batch = stack_batches([TokenTrie(s, a) for s, a in tries], ec, engine=step.engine, mesh=mesh)
    routes, drops = [], []
    if record_routes:
        route, dispatch, apply = tp_model.moe_route, tp_model.ep_dispatch, tp_model.moe_apply

        def rec_route(*a, **k):
            out = route(*a, **k)
            if torch.is_grad_enabled():
                routes.append(out[1].numpy())
            return out

        def rec_dispatch(idx, *a):
            out = dispatch(idx, *a)
            drops.append(int((idx.numpy() < mc.num_experts).sum()) - int(out[1].sum()))
            return out

        def rec_apply(h, g, u, d, idx, w, cap):
            counts = np.bincount(idx.numpy().ravel()[(idx.numpy().ravel() >= 0)
                                                     & (idx.numpy().ravel() < g.shape[0])], minlength=g.shape[0])
            drops.append(int(np.maximum(counts - cap, 0).sum()))
            return apply(h, g, u, d, idx, w, cap)

        tp_model.moe_route, tp_model.ep_dispatch, tp_model.moe_apply = rec_route, rec_dispatch, rec_apply
    try:
        loss, grads, aux = step(shard_params(full, mesh, mc, ep_size), batch)
    finally:
        if record_routes:
            tp_model.moe_route, tp_model.ep_dispatch, tp_model.moe_apply = route, dispatch, apply
    g = gather_params(grads, mesh, mc, ep_size)
    out = {"loss": loss.numpy(), **{k: v.numpy() for k, v in aux.items()}, "n_pad": np.int64(batch.packeds[0].n_padded),
           "expert_rows": np.int64(grads["layers"]["e_gate"].shape[1]) if mc.is_moe else np.int64(0)}
    if record_routes:
        out["routes"] = np.stack(routes)
        out["drops"] = np.asarray(drops)
    if _lead():
        out.update(_named(g, "g/"))
    return out


def scaled_loss(lp, ent, extras, length):
    """A per-sequence loss with an extra (the custom-loss contract):
    -scale · Σ lp + 0.1 · mean entropy over the sequence."""
    m_lp = (torch.arange(lp.shape[0]) < length - 1).float()
    m_en = (torch.arange(ent.shape[0]) < length).float()
    return -extras["scale"] * (lp * m_lp).sum() + 0.1 * (ent * m_en).sum() / length


def case_custom(dp, tp, cfg, ecfg, params, tries, scales):
    """make_train_step with `scaled_loss` on the mesh: each rank uploads its
    row of the extras [dp, S]; the loss on every rank, rank 0 the grads."""
    mc, ec, mesh, full = _common(cfg, ecfg, params, dp, tp)
    if mesh is None:
        return None
    step = make_train_step(mc, ec, custom_loss=scaled_loss, mesh=mesh)
    batch = stack_batches([TokenTrie(s, a) for s, a in tries], ec, engine=step.engine, with_paths=True, mesh=mesh)
    batch.add("x_scale", scales)
    loss, grads, aux = step(shard_params(full, mesh, mc), batch)
    out = {"loss": loss.numpy(), **{k: v.numpy() for k, v in aux.items()}}
    g = gather_params(grads, mesh, mc)
    if _lead():
        out.update(_named(g, "g/"))
    return out


def case_forward(dp, tp, cfg, ecfg, params, tries):
    """make_forward_step + extract_forward: rank 0 writes every data rank's
    per-sequence log-probs."""
    from dynamictreeattn_tpu_torch.parallel import extract_forward

    mc, ec, mesh, full = _common(cfg, ecfg, params, dp, tp)
    if mesh is None:
        return None
    step = make_forward_step(mc, ec, mesh=mesh)
    batch = stack_batches([TokenTrie(s, a) for s, a in tries], ec, engine=step.engine, mesh=mesh)
    lp, ent = step(shard_params(full, mesh, mc), batch)
    got = extract_forward(batch, lp)
    out = {"finite": np.bool_(torch.isfinite(ent).all().item()), "shape": np.asarray(lp.shape)}
    if _lead():
        out.update({f"lp/{r}/{k}": v for r, per in enumerate(got) for k, v in per.items()})
    return out


def case_opt(dp, tp, cfg, ecfg, params, tries, clip, steps, lr):
    """`steps` optimizer steps on one batch through make_train_step with
    OptaxAdamW (clip over the global norm); the losses and the params
    gathered after."""
    mc, ec, mesh, full = _common(cfg, ecfg, params, dp, tp)
    if mesh is None:
        return None
    opt = OptaxAdamW(lr, grad_clip=clip, sum_squares=global_sum_squares(mesh, mc))
    step = make_train_step(mc, ec, optimizer=opt, mesh=mesh)
    batch = stack_batches([TokenTrie(s, a) for s, a in tries], ec, engine=step.engine, mesh=mesh)
    p = shard_params(full, mesh, mc)
    state = opt.init(p)
    losses = []
    for _ in range(steps):
        p, state, loss, _ = step(p, state, batch)
        losses.append(float(loss))
    g = gather_params(p, mesh, mc)
    out = {"losses": np.asarray(losses)}
    if _lead():
        out.update(_named(g, "p/"))
    return out


def case_trainer(dp, tp, cfg, ecfg, params, batches, tc, ep=False, prompts=None):
    """Trainer over `batches`: the records' numbers on every rank, the cost
    model's fitted times, and the params gathered after (rank 0)."""
    mc, ec, mesh, full = _common(cfg, ecfg, params, dp, tp)
    if mesh is None:
        return None
    tr = Trainer(mc, ec, TrainConfig(dp=dp, tp=tp, ep=ep, **tc), mesh=mesh, device="cpu")
    tr.set_params(full)
    recs = [tr.train_step(s, a) for s, a in batches]
    out = {key: np.asarray([r[key] for r in recs]) for key in ("loss", "sum_logprob", "sum_entropy",
                                                                  "n_tree_tokens")}
    out["fit_times"] = np.asarray(tr.time_model._y, np.float64)
    if prompts is not None:  # forward_logprobs of the first batch and a greedy rollout, after the steps
        out["forward"] = np.concatenate(tr.forward_logprobs(*batches[0]))
        out["rollout"] = tr.rollout(prompts, np.array([prompts.shape[1], 5], np.int32), group=2, max_new=4,
                                    greedy=True)
    p = tr.full_params()
    if _lead():
        out.update(_named(p, "p/"))
    return out


def case_ckpt(dp, tp, cfg, ecfg, tc, restore_dir, save_dir, batch):
    """Restore a checkpoint written on one device, gather what was restored
    (rank 0 writes it), take one step, save at this mesh."""
    from dynamictreeattn_tpu_torch.training import CheckpointManager
    from dynamictreeattn_tpu_torch.training.trainer import _state_tree

    mc, ec, mesh, _ = _common(cfg, ecfg, None, dp, tp)
    if mesh is None:
        return None
    tr = Trainer(mc, ec, TrainConfig(dp=dp, tp=tp, ckpt_dir=restore_dir, **tc), mesh=mesh, device="cpu")
    tr.restore()
    out = {"step_idx": np.int64(tr.step_idx), "count": tr.opt_state["count"].numpy()}
    p = tr.full_params()
    mu = gather_params(_state_tree(tr.opt_state["mu"], tr.params), mesh, mc)
    if _lead():
        out.update(_named(p, "restored/"))
        out.update(_named(mu, "mu/"))
    rec = tr.train_step(*batch)
    out["next_loss"] = np.float64(rec["loss"])
    tr._ckpt = CheckpointManager(save_dir)
    tr.save()
    p = tr.full_params()
    if _lead():
        out.update(_named(p, "after/"))
    return out


def case_cli(argv):
    """cli.train inside the ranks' group (as under torchrun); whether this
    rank trained (a rank beyond the mesh's dp·tp returns at once)."""
    from dynamictreeattn_tpu_torch.cli import train as cli_train

    return {"trained": np.bool_(cli_train.main(argv) is not None)}


def main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    for name, fn, kwargs in cases:
        out = globals()["case_" + fn](**kwargs)
        if out is not None:
            np.savez(os.path.join(workdir, f"{name}.{rank}.npz"), **out)
    blocked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dynamictreeattn_tpu")]
    if blocked:
        raise RuntimeError(f"a rank imported {blocked[:5]}")
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
