"""The port's grouped-decode attention (K13's plain version, and the wrapper
on CPU tensors) against a JAX concatenated-softmax oracle — the formula of
tests/test_generate.py's kernel test — and, opt-in, the JAX Pallas kernel in
interpret mode.

fp32 inputs from seeded numpy: 2e-5 (the JAX suite's bar for its kernel; the
same fp32 softmax summed in another order). Lp and Nc are not multiples of
the chunk sizes: the port masks by plen and t, where the TPU kernel needs
padded caches.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu_torch.ops.decode_attention import (
    decode_attention_grouped, decode_attention_grouped_plain,
)

ATOL = 2e-5
# bf16 inputs against the fp32 oracle on the same (bf16-representable)
# values: the output is rounded to bf16 (2^-8 relative) and P is rounded to
# bf16 before P*V (2^-9 relative per weight): 1e-2 absolute at |o| <= ~1.5.
BF16_ATOL = 1e-2

# Lp, Nc and plen 300 are no multiples of the chunks (256 prompt, 128 branch columns)
P, G, HKV, LP, NC = 2, 3, 2, 520, 300
PLENS = (300, 512)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, grp, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    hq = grp * HKV

    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)

    return (r(P, G, hq, dh), r(P, G, HKV, dh), r(P, G, HKV, dh), r(P, HKV, LP, dh), r(P, HKV, LP, dh),
            r(P, G, HKV, NC, dh), r(P, G, HKV, NC, dh), np.array(PLENS, np.int32))


def _oracle(q, k_self, v_self, kp, vp, kc, vc, plens, t):
    """softmax over [prompt cols < plen | own cols < t | self], in JAX at
    the highest matmul precision."""
    Pn, Gn, hq, dh = q.shape
    hkv, Lp, Nc = kp.shape[1], kp.shape[2], kc.shape[3]
    scale = dh**-0.5
    with jax.default_matmul_precision("highest"):
        qh = jnp.asarray(q).reshape(Pn, Gn, hkv, hq // hkv, dh)
        st_p = jnp.einsum("pgkrd,pkjd->pgkrj", qh, kp) * scale
        st_p = jnp.where(jnp.arange(Lp) < jnp.asarray(plens)[:, None, None, None, None], st_p, -1e30)
        st_c = jnp.einsum("pgkrd,pgkjd->pgkrj", qh, kc) * scale
        st_c = jnp.where(jnp.arange(Nc) < t, st_c, -1e30)
        st_s = jnp.einsum("pgkrd,pgkd->pgkr", qh, k_self) * scale
        p = jax.nn.softmax(jnp.concatenate([st_p, st_c, st_s[..., None]], axis=-1), axis=-1)
        o = (jnp.einsum("pgkrj,pkjd->pgkrd", p[..., :Lp], vp)
             + jnp.einsum("pgkrj,pgkjd->pgkrd", p[..., Lp:Lp + Nc], vc)
             + p[..., -1:] * jnp.asarray(v_self)[:, :, :, None, :])
    return np.asarray(o.reshape(Pn, Gn, hq, dh))


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("grp", [1, 2, 3, 7])
@pytest.mark.parametrize("t", [0, 1, 100, 255])
def test_plain_matches_concatenated_softmax_oracle(t, grp, dh):
    arrays = _inputs(t + 10 * grp + dh, grp, dh)
    got = decode_attention_grouped_plain(*_torch(arrays), t)
    np.testing.assert_allclose(got.numpy(), _oracle(*arrays, t), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [0, 255])
def test_plain_never_reads_past_plen_or_t(t):
    """NaN in every cache column >= plen and >= t leaves the output finite
    and unchanged: those columns are sliced away, not masked after a read."""
    arrays = _inputs(5, 2, 64)
    clean = decode_attention_grouped_plain(*_torch(arrays), t)
    q, ks, vs, kp, vp, kc, vc, plens = (a.copy() for a in arrays)
    for p, n in enumerate(PLENS):
        kp[p, :, n:] = vp[p, :, n:] = np.nan
    kc[:, :, :, t:] = vc[:, :, :, t:] = np.nan
    got = decode_attention_grouped_plain(*_torch((q, ks, vs, kp, vp, kc, vc, plens)), t)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


@pytest.mark.parametrize("t", [1, 255])
def test_plain_bf16_inputs_match_fp32_oracle(t):
    arrays = _inputs(7, 2, 128)
    as_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:7]]
    got = decode_attention_grouped_plain(*as_bf16, torch.from_numpy(arrays[7]), t)
    assert got.dtype == torch.bfloat16
    want = _oracle(*[a.float().numpy() for a in as_bf16], arrays[7], t)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("t", [0, 1, 100, NC])
def test_plain_takes_t_as_an_int32_tensor(t):
    """A step t held in a one-element int32 tensor (as the replayed decode
    step holds it) gives the int-t result exactly, through the plain version
    and the CPU wrapper; t = Nc reads every branch column."""
    arrays = _torch(_inputs(11 + t, 2, 64))
    want = decode_attention_grouped_plain(*arrays, t)
    for t_dev in (torch.tensor(t, dtype=torch.int32), torch.tensor([t], dtype=torch.int32)):
        torch.testing.assert_close(decode_attention_grouped_plain(*arrays, t_dev), want, rtol=0, atol=0)
        torch.testing.assert_close(decode_attention_grouped(*arrays, t_dev), want, rtol=0, atol=0)


def test_captured_launches_count_once_per_replay():
    """Launches counted while a graph is captured go to the capture's tally,
    not to LAUNCHES; each replay adds the tally once."""
    from dynamictreeattn_tpu_torch.ops import _build

    before = dict(_build.LAUNCHES)
    with _build.captured_launches() as counts:
        for _ in range(3):
            _build.count_launch("decode_attn")
    assert counts == {"decode_attn": 3} and _build.LAUNCHES == before
    for _ in range(2):
        _build.add_launches(counts)
    assert _build.LAUNCHES["decode_attn"] == before["decode_attn"] + 6
    _build.LAUNCHES.update(before)


def test_wrapper_runs_the_plain_version_on_cpu():
    arrays = _torch(_inputs(3, 2, 64))
    torch.testing.assert_close(decode_attention_grouped(*arrays, 17),
                               decode_attention_grouped_plain(*arrays, 17), rtol=0, atol=0)


def test_wrapper_launches_or_raises_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which refuses what is not a CUDA tensor (no fallback)."""
    q = torch.zeros((P, G, 4, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.zeros((P, G, HKV, 64), dtype=torch.bfloat16, device="meta")
    kp = torch.zeros((P, HKV, LP, 64), dtype=torch.bfloat16, device="meta")
    kc = torch.zeros((P, G, HKV, NC, 64), dtype=torch.bfloat16, device="meta")
    plens = torch.zeros(P, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_grouped(q, kv, kv, kp, kp, kc, kc, plens, 3)


@pytest.mark.skipif(
    not os.environ.get("RUN_INTERPRET"),
    reason="Pallas interpret-mode compile is slow; opt in with RUN_INTERPRET=1 (as the JAX suite's "
           "own decode-attention kernel test)",
)
@pytest.mark.parametrize("t", [0, 100, 255])
def test_plain_matches_jax_kernel_in_interpret_mode(t):
    from dynamictreeattn_tpu.ops.decode_attention import decode_attention_grouped as jax_k13

    rng = np.random.default_rng(t)
    Lp, Nc, hq, dh = 512, 256, 4, 128  # the TPU kernel needs chunk-divisible caches

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    arrays = (r(P, G, hq, dh), r(P, G, HKV, dh), r(P, G, HKV, dh), r(P, HKV, Lp, dh), r(P, HKV, Lp, dh),
              r(P, G, HKV, Nc, dh), r(P, G, HKV, Nc, dh), np.array(PLENS, np.int32))
    with jax.default_matmul_precision("highest"):
        want = jax_k13(*map(jnp.asarray, arrays), jnp.int32(t), prompt_chunk=256, branch_chunk=128,
                       interpret=True)
    got = decode_attention_grouped_plain(*_torch(arrays), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
