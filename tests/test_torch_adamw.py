"""The optimizer layer (``ops/adamw.py``): the clip's sum of squares and the
AdamW update.

CPU: ``OptaxAdamW.update``, which now runs the wrapper's plain version,
bit-equal step for step to the eager chain it ran before the kernels
(``_eager_update``, kept here as it was), at fp32 and bf16, with the clip
triggered, not triggered and off, weight decay, warmup, a step whose loss
was not finite, accumulation over two micro-steps and a ragged leaf list
cut into many slices; the kernels' walk (``plan``) covering every element
of every leaf exactly once, its vectors on 16-byte boundaries, its units
dealt evenly over the threads; the wrappers' layout checks.

On the card only (``card``; skipped without one): the kernel bit-equal to
the plain version given the same clip factors at Qwen3-0.6B's and
Qwen3-30B-A3B-8l's leaves and on a ragged list (bf16 and fp32, unaligned
views, a transposed leaf, more leaves than one launch holds), the sum of
squares within 1e-6 relative of the eager fp32 norm and bit-equal from run
to run, and a step with commit False changing no byte.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
from dynamictreeattn_tpu_torch.ops import _build, adamw
from dynamictreeattn_tpu_torch.training import OptaxAdamW
from dynamictreeattn_tpu_torch.training.trainer import _leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eager_update(opt, grads, state, params, good):
    """``OptaxAdamW.update`` as it was before the kernels: the clip in place
    on the grads, then the chain over whole leaves."""
    gs, ps = _leaves(grads), _leaves(params)
    k, commit = opt.k, good
    if k > 1:
        mini = state["mini_step"]
        emit = mini == k - 1
        for g, acc in zip(gs, state["acc"]):
            g.sub_(acc).div_((mini + 1).to(g.dtype)).add_(acc)
            acc.copy_(torch.where(good, torch.where(emit, torch.zeros_like(g), g), acc))
        state["mini_step"] = torch.where(good, (mini + 1) % k, mini)
        commit = good & emit
    if opt.clip:
        norm = torch.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in gs))
        trigger = norm < opt.clip
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        div, mul = torch.where(trigger, one, norm), torch.where(trigger, one, one * opt.clip)
        for g in gs:
            g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    count = state["count"] + 1
    bc1 = 1 - torch.pow(opt.b1, count.float())
    bc2 = 1 - torch.pow(opt.b2, count.float())
    lr = opt._lr(state["count"])
    for i, (p, g) in enumerate(zip(ps, gs)):
        mc, nc = state["mu"][i], state["nu"][i]
        mu = (1 - opt.b1) * g + opt.b1 * mc
        nu = (1 - opt.b2) * (g * g) + opt.b2 * nc
        u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + opt.eps)
        u = (u + opt.wd * p) * lr.to(u.dtype)
        torch.where(commit, (p + u).to(p.dtype), p, out=p)
        torch.where(commit, mu, mc, out=mc)
        torch.where(commit, nu, nc, out=nc)
    c = commit.to(torch.int32)
    state["count"] = state["count"] + c
    state["gradient_step"] = state["gradient_step"] + c
    return params, state


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _bit_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_bit_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return a.shape == b.shape and a.stride() == b.stride() and torch.equal(_bits(a), _bits(b))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return None if tree is None else tree.clone()


LEAVES = {"a": (5, 7), "b": {"c": (33,), "d": (2, 3, 4)}}
# a 0-d leaf, one-element leaves, odd sizes, a transposed view, and "big"
# cut into many slices once CHUNK is 64
RAGGED = {"scalar": (), "one": (1,), "one2": (1, 1), "odd": (37,), "t": "transposed", "big": (300, 3),
          "w": {"x": (13, 5), "y": (2, 9)}}

CASES = {
    "clip_triggered": dict(opt=dict(grad_clip=0.05)),
    "clip_not_triggered": dict(opt=dict(grad_clip=1e6)),
    "no_clip": dict(opt=dict(grad_clip=0.0)),
    "weight_decay": dict(opt=dict(grad_clip=0.05, weight_decay=0.1)),
    "warmup": dict(opt=dict(grad_clip=0.05, warmup_steps=3)),
    "good_false": dict(opt=dict(grad_clip=0.05), goods=(True, False, True)),
    "grad_accum_2": dict(opt=dict(grad_clip=0.05, grad_accum=2), goods=(True, True, False, True, True)),
    "ragged_chunked": dict(opt=dict(grad_clip=0.05, weight_decay=0.01), leaves=RAGGED, chunk=64),
}


def _tree(spec, gen, dtype, scale):
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _tree(v, gen, dtype, scale)
        elif v == "transposed":  # a [d, V] view of [V, d] storage, as an untied head
            out[k] = (torch.randn(11, 6, generator=gen) * scale).to(dtype).t()
        else:
            out[k] = (torch.randn(v, generator=gen) * scale).to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_update_equals_the_eager_chain(case, dtype, monkeypatch):
    """Step for step, params and every part of the state bit-equal to the
    eager chain; a step whose `good` is False leaves them bit-unchanged."""
    spec = CASES[case]
    if "chunk" in spec:
        monkeypatch.setattr(adamw, "CHUNK", spec["chunk"])
    leaves = spec.get("leaves", LEAVES)
    opt = OptaxAdamW(1e-2, **spec["opt"])
    gen = torch.Generator().manual_seed(0)
    params = _tree(leaves, gen, dtype, 1.0)
    ref_params, ref_state = _clone(params), opt.init(params)
    state = _clone(ref_state)
    for good in spec.get("goods", (True, True, True)):
        grads = _tree(leaves, gen, dtype, 0.1)
        before = _clone(params), _clone(state)
        _eager_update(opt, _clone(grads), ref_state, ref_params, torch.tensor(good))
        opt.update(_clone(grads), state, params, torch.tensor(good))
        assert _bit_equal(params, ref_params) and _bit_equal(state, ref_state), case
        if not good:
            assert _bit_equal(params, before[0]) and _bit_equal(state, before[1])
    assert int(state["count"]) == sum(spec.get("goods", (True,) * 3)) // opt.k


def _replay(launches, leaves, threads):
    """Each element's count of visits, walking the plan as the kernel does,
    and each launch's units per thread."""
    seen = [np.zeros(numel, np.int64) for _, numel, _ in leaves]
    per_thread = []
    for size, walks in launches:
        assert 1 <= len(walks) <= adamw.MAX_LEAVES and all(leaves[w[0]][2] == size for w in walks)
        vec = adamw.VEC_BYTES // size
        owners = []
        for i, head, nvec, tail, rot in walks:
            addrs, numel, _ = leaves[i]
            assert head + nvec * vec + tail == numel
            if nvec:
                assert head < vec and tail < vec
                assert all((a + head * size) % adamw.VEC_BYTES == 0 for a in addrs)
            units = np.arange(nvec + head + tail)
            owners.append((units + rot) % threads)
            np.add.at(seen[i], (head + units[:nvec, None] * vec + np.arange(vec)).ravel(), 1)
            scalars = units[nvec:] - nvec
            np.add.at(seen[i], np.where(scalars >= head, scalars + nvec * vec, scalars), 1)
        per_thread.append(np.bincount(np.concatenate(owners), minlength=threads))
    return seen, per_thread


def _plan_case(name):
    """leaves (addresses, numel, element bytes) of one walk case."""
    rng = np.random.default_rng(len(name))
    numels = [1, 1, 7, 8, 9, 1000, 4099, 513]
    if name == "aligned":
        return [((512 * k,) * 4, n, 2) for k, n in enumerate(numels)]
    if name == "offset":  # every tensor of a leaf off a 16-byte boundary by the same bytes
        return [(tuple(512 * (4 * k + j) + off for j in range(4)), n, size)
                for k, (n, (off, size)) in enumerate(zip(numels, [(2, 2), (6, 2), (14, 2), (4, 4), (12, 4)] * 2))]
    if name == "misaligned":  # the moments off by other amounts than the param
        return [((512 * k, 512 * k + 2, 512 * k + 4, 512 * k + 2), n, 2) for k, n in enumerate(numels)]
    if name == "many":  # more leaves than a launch holds
        return [((512 * k + 2 * int(rng.integers(8)),) * 4, int(rng.integers(1, 300)), 2) for k in range(150)]
    if name == "mixed":  # bf16 and fp32 leaves interleaved: a launch a dtype
        return [((512 * k,) * 4, n, 2 if k % 2 else 4) for k, n in enumerate(numels * 2)]
    if name == "empty":
        return [((0,) * 4, 0, 2), ((512,) * 4, 100, 2), ((1024,) * 4, 0, 2), ((2048,) * 4, 3, 2)]
    raise KeyError(name)


@pytest.mark.parametrize("threads", [96, 4096])
@pytest.mark.parametrize("name", ["aligned", "offset", "misaligned", "many", "mixed", "empty"])
def test_plan_covers_every_element_once(name, threads):
    """Every element of every leaf visited exactly once; vectors on 16-byte
    boundaries of all four tensors; launches of one element size, at most
    MAX_LEAVES leaves each, every non-empty leaf in one; a launch's units
    dealt round-robin, so its threads' counts differ by at most one."""
    leaves = _plan_case(name)
    launches = adamw.plan(leaves, threads)
    placed = [w[0] for _, walks in launches for w in walks]
    assert sorted(placed) == [i for i, (_, n, _) in enumerate(leaves) if n]
    seen, per_thread = _replay(launches, leaves, threads)
    assert all((s == 1).all() for s in seen)
    assert all(c.max() - c.min() <= 1 for c in per_thread)
    if name == "misaligned":
        assert all(nvec == 0 for _, walks in launches for _, _, nvec, _, _ in walks)
    if name == "many":
        assert len(launches) == 3


def test_checks_refuse_what_the_kernels_do_not_take():
    """Half precision and moments of another layout than their param raise;
    a gradient of another layout is copied into its param's."""
    cpu = torch.device("cpu")
    p = torch.zeros(4, 6).t()  # transposed storage
    with pytest.raises(TypeError, match="bf16 and fp32"):
        adamw._checked([(p.half(), p.half(), p.half(), p.half())], cpu)
    with pytest.raises(ValueError, match="layout"):
        adamw._checked([(p, torch.zeros_like(p), torch.zeros(6, 4), torch.zeros_like(p))], cpu)
    with pytest.raises(ValueError, match="not dense"):
        base = torch.zeros(6, 8)[:, :4]
        adamw._checked([(base, base, base, base)], cpu)
    g = torch.arange(24.0).reshape(6, 4)
    (fixed,) = adamw._checked([(p, g, torch.zeros_like(p), torch.zeros_like(p))], cpu)
    assert fixed[1].stride() == p.stride() and torch.equal(fixed[1], g)


# ------------------------------------------------------------------ the card


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _layouts(name: str) -> list:
    """(shape, strides) of each leaf of a benchmark config's params, from
    ``init_params`` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mc = MODEL_CONFIGS["qwen3-30b-a3b" if name.startswith("qwen3-30b") else name]
    if name == "qwen3-30b-a3b-8l":
        mc = dataclasses.replace(mc, num_hidden_layers=8)
    with FakeTensorMode():
        params = init_params(mc, torch.Generator(), torch.bfloat16)
    return [(tuple(t.shape), t.stride()) for t in _leaves(params)]


def _draw(layout, dtype, seed, device, offset=0):
    """(p, g, mu, nu) of one leaf in `layout`, seeded, nu >= 0; each tensor
    `offset` elements into its storage."""
    shape, stride = layout
    n = math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for scale in (0.02, 1e-3, 1e-4, 1e-3):
        t = torch.randn(n + offset, generator=gen, device=device, dtype=dtype).mul_(scale)
        out.append(t[offset:].as_strided(shape, stride))
    out[3].mul_(out[3])
    return tuple(out)


def _scalars(device, clip, wd=0.01):
    f32 = dict(dtype=torch.float32, device=device)
    count = torch.tensor(3.0, **f32)
    return dict(lr=torch.tensor(-1e-3, **f32), bc1=1 - torch.pow(0.9, count), bc2=1 - torch.pow(0.999, count),
                commit=torch.tensor(True, device=device), clip=clip, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)


@pytest.mark.card
@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen3-30b-a3b-8l"])
def test_kernel_equals_plain_at_real_leaves(name):
    """All the config's leaves in one launch: bit-equal to the plain
    version leaf by leaf (each redrawn from its seed), the grads unchanged;
    the sum of squares within 1e-6 of the eager fp32 norm, the same bits
    twice."""
    dev = _card()
    layouts = _layouts(name)
    leaves = [_draw(lay, torch.bfloat16, i, dev) for i, lay in enumerate(layouts)]
    gs = [g for _, g, _, _ in leaves]
    ss = adamw.sum_squares(gs)
    assert torch.equal(ss, adamw.sum_squares(gs))
    ref = float(torch.sqrt(adamw.sum_squares_plain(gs)))
    assert abs(math.sqrt(float(ss)) - ref) <= 1e-6 * ref
    kw = _scalars(dev, (torch.sqrt(ss), torch.ones((), device=dev)))
    before = _build.LAUNCHES["adamw_update"]
    adamw.adamw_update(*map(list, zip(*leaves)), **kw)
    assert _build.LAUNCHES["adamw_update"] == before + 1
    for i, (lay, got) in enumerate(zip(layouts, leaves)):
        want = _draw(lay, torch.bfloat16, i, dev)
        assert _bit_equal(got[1], want[1]), f"leaf {i}: the kernel wrote the gradient"
        adamw.adamw_update_plain(*([t] for t in want), **kw)
        assert all(_bit_equal(got[j], want[j]) for j in (0, 2, 3)), f"leaf {i} {lay[0]}"
        del want
    del leaves, gs
    torch.cuda.empty_cache()


def _ragged(dev):
    """(p, g, mu, nu) leaves: bf16 and fp32, 0-d, one element, odd sizes,
    views off 16-byte boundaries, moments misaligned against their param, a
    transposed leaf with a contiguous gradient, and 70 more small leaves."""
    leaves, seed = [], 100
    for dtype in (torch.bfloat16, torch.float32):
        for shape, offset in [((), 0), ((1,), 0), ((37,), 1), ((4099,), 3), ((129, 7), 5), (((1 << 16) + 3,), 0)]:
            leaves.append(_draw((shape, torch.empty(shape).stride()), dtype, seed, dev, offset))
            seed += 1
        p, g, m, v = _draw(((1001,), (1,)), dtype, seed, dev, 1)
        m2 = torch.empty(1003, dtype=dtype, device=dev)[2:].copy_(m)  # off by another amount than p
        leaves.append((p, g, m2, v))
        p, g, m, v = _draw(((96, 40), (1, 96)), dtype, seed + 1, dev)
        leaves.append((p, g.contiguous(), m, v))
        seed += 2
    for k in range(70):
        leaves.append(_draw(((3 + k,), (1,)), torch.bfloat16, seed + k, dev, k % 8))
    return leaves


@pytest.mark.card
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
def test_kernel_equals_plain_on_a_ragged_list(clip):
    """The ragged list through the kernels (three update launches) equals
    the plain version bit for bit; the sum of squares within 1e-6."""
    dev = _card()
    leaves = _ragged(dev)
    want = [tuple(t.clone() for t in leaf) for leaf in leaves]
    gs = [g for _, g, _, _ in leaves]
    ss = adamw.sum_squares(gs)
    ref = float(torch.sqrt(adamw.sum_squares_plain(gs)))
    assert abs(math.sqrt(float(ss)) - ref) <= 1e-6 * ref
    kw = _scalars(dev, (torch.sqrt(ss), torch.full((), 0.5, device=dev)) if clip else None)
    before = _build.LAUNCHES["adamw_update"]
    adamw.adamw_update(*map(list, zip(*leaves)), **kw)
    assert _build.LAUNCHES["adamw_update"] == before + 3  # bf16: 8 + 70 leaves in two; fp32 in one
    adamw.adamw_update_plain(*map(list, zip(*want)), **kw)
    for i, (got, ref_leaf) in enumerate(zip(leaves, want)):
        assert all(_bit_equal(got[j], ref_leaf[j]) for j in (0, 2, 3)), f"leaf {i}"


@pytest.mark.card
def test_commit_false_changes_no_byte():
    dev = _card()
    leaves = _ragged(dev)
    before = [tuple(t.clone() for t in leaf) for leaf in leaves]
    kw = _scalars(dev, (torch.full((), 2.0, device=dev), torch.ones((), device=dev)))
    kw["commit"] = torch.tensor(False, device=dev)
    adamw.adamw_update(*map(list, zip(*leaves)), **kw)
    assert all(_bit_equal(a, b) for got, ref in zip(leaves, before) for a, b in zip(got, ref))
