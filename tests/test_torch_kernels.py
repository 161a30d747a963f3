"""The port's attention kernels against the JAX package's.

On the CPU: each plain PyTorch version (``repro_torch.kernels.ref``, which
CPU tensors take through ``ops``) against the JAX oracle in
``repro.kernels.ref`` and against the Pallas kernel run in interpret mode,
as tests/test_kernels.py runs it.  Inputs come from numpy with a fixed seed
and go to both frameworks as the same values.

``gpu``-marked tests run each CUDA kernel against its plain version on the
card; they skip on a host without one.  JAX is imported by a fixture, so
this file also collects on a machine that has the card but no JAX.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ops import (
        decode_attention,
        flash_attention,
        paged_decode_attention,
    )
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ref=jref, flash=flash_attention,
        decode=decode_attention, paged=paged_decode_attention)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(x, dtype, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                        dtype=TORCH_DT[dtype])


def _j(jx, x, dtype):
    return jx.jnp.asarray(x, getattr(jx.jnp, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32))


def _decode_inputs(seed, B, S, H, KV, hd, lengths):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32),
            np.asarray(lengths, np.int32))


def _paged_inputs(seed, B, P, PP, page, H, KV, hd):
    """Pools plus a permuted block table: pages land in scattered pool rows
    and unused tail entries are -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd), np.float32)
    kp = rng.standard_normal((P, page, KV, hd), np.float32)
    vp = rng.standard_normal((P, page, KV, hd), np.float32)
    bt = np.full((B, PP), -1, np.int32)
    lengths = np.zeros((B,), np.int32)
    perm = rng.permutation(P)
    used = 0
    for b in range(B):
        n = int(rng.integers(1, PP + 1))
        bt[b, :n] = perm[used:used + n]
        used += n
        lengths[b] = int(rng.integers(1, n * page + 1))
    return q, kp, vp, bt, lengths


# (dtype, H, KV, hd, window): G = 1, 2, 4; windows 0 and 128
FLASH_CASES = [
    ("float32", 4, 4, 64, 0),
    ("float32", 4, 2, 32, 128),
    ("float32", 8, 2, 128, 0),
    ("bfloat16", 4, 1, 64, 128),
    ("bfloat16", 8, 2, 64, 0),
]


@pytest.mark.parametrize("dtype,H,KV,hd,window", FLASH_CASES)
def test_flash_plain_matches_jax_oracle_and_pallas(jx, dtype, H, KV, hd, window):
    q, k, v = _qkv(1, 1, 256, H, KV, hd)
    out = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=True, window=window)
    jq, jk, jv = (_j(jx, a, dtype) for a in (q, k, v))
    oracle = jx.ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    pallas = jx.flash(jq, jk, jv, causal=True, window=window, use_pallas=True,
                      block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])


# lengths: 1, partial and full (S = 256)
DECODE_CASES = [
    ("float32", 4, 4, 64, [1, 256]),
    ("float32", 4, 2, 128, [97, 1]),
    ("float32", 8, 2, 32, [256, 130]),
    ("bfloat16", 4, 1, 64, [1, 200]),
    ("bfloat16", 8, 2, 128, [256, 17]),
]


@pytest.mark.parametrize("dtype,H,KV,hd,lengths", DECODE_CASES)
def test_decode_plain_matches_jax_oracle_and_pallas(jx, dtype, H, KV, hd, lengths):
    q, kc, vc, ln = _decode_inputs(2, len(lengths), 256, H, KV, hd, lengths)
    out = ops.decode_attention(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                               torch.from_numpy(ln))
    jargs = [_j(jx, a, dtype) for a in (q, kc, vc)] + [jx.jnp.asarray(ln)]
    oracle = jx.ref.decode_attention_ref(*jargs)
    pallas = jx.decode(*jargs, use_pallas=True, block_s=128, interpret=True)
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])


# (dtype, page, PP, H, KV, hd)
PAGED_CASES = [
    ("float32", 16, 4, 4, 4, 64),
    ("float32", 16, 3, 8, 2, 128),
    ("float32", 32, 2, 4, 2, 32),
    ("bfloat16", 16, 4, 4, 1, 64),
    ("bfloat16", 32, 4, 8, 2, 128),
]


@pytest.mark.parametrize("dtype,page,PP,H,KV,hd", PAGED_CASES)
def test_paged_plain_matches_jax_oracle_and_pallas(jx, dtype, page, PP, H, KV, hd):
    B = 3
    q, kp, vp, bt, ln = _paged_inputs(3, B, B * PP + 3, PP, page, H, KV, hd)
    out = ops.paged_decode_attention(_t(q, dtype), _t(kp, dtype), _t(vp, dtype),
                                     torch.from_numpy(bt), torch.from_numpy(ln))
    jargs = [_j(jx, a, dtype) for a in (q, kp, vp)] + \
        [jx.jnp.asarray(bt), jx.jnp.asarray(ln)]
    oracle = jx.ref.paged_decode_attention_ref(*jargs)
    pallas = jx.paged(*jargs, use_pallas=True, interpret=True)
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])


def test_paged_plain_matches_dense_plain_on_gathered_cache():
    """The layout is invisible: attention through the block table equals
    dense attention over the gathered cache."""
    B, PP, page, H, KV, hd = 2, 4, 16, 8, 2, 64
    q, kp, vp, bt, ln = _paged_inputs(11, B, 12, PP, page, H, KV, hd)
    q, kp, vp = (torch.from_numpy(a) for a in (q, kp, vp))
    bt, ln = torch.from_numpy(bt), torch.from_numpy(ln)
    paged = ref.paged_decode_attention_ref(q, kp, vp, bt, ln)
    idx = bt.long().clamp(min=0)
    dense = ref.decode_attention_ref(
        q, kp[idx].reshape(B, PP * page, KV, hd),
        vp[idx].reshape(B, PP * page, KV, hd), ln)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), rtol=2e-4, atol=2e-4)


def test_cpu_tensors_never_count_launches():
    ops.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 32, 4, 2, 32))
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, 0], k, v, torch.tensor([5], dtype=torch.int32))
    assert ops.LAUNCHES == {"decode_attention": 0,
                            "paged_decode_attention": 0,
                            "flash_attention": 0}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

# (dtype, H, KV, hd): qwen3-8b's G = 4 / hd 128 and a G = 1 / hd 64 case
GPU_HEADS = [("float32", 32, 8, 128), ("bfloat16", 32, 8, 128),
             ("float32", 8, 8, 64), ("bfloat16", 8, 8, 64),
             ("bfloat16", 4, 2, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,H,KV,hd", GPU_HEADS)
def test_cuda_flash_matches_plain(cuda, dtype, H, KV, hd):
    for S, window in ((200, 0), (333, 128), (64, 0), (1, 0)):
        q, k, v = (_t(a, dtype, cuda) for a in _qkv(5, 2, S, H, KV, hd))
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,H,KV,hd", GPU_HEADS)
def test_cuda_decode_matches_plain(cuda, dtype, H, KV, hd):
    S = 300
    q, kc, vc, ln = _decode_inputs(6, 4, S, H, KV, hd, [1, 31, 257, S])
    args = [_t(a, dtype, cuda) for a in (q, kc, vc)]
    lengths = torch.from_numpy(ln).to(cuda)
    got = ops.decode_attention(*args, lengths)
    want = ref.decode_attention_ref(*args, lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,H,KV,hd", GPU_HEADS)
def test_cuda_paged_decode_matches_plain_and_dense_kernel(cuda, dtype, H, KV, hd):
    B, PP, page = 3, 5, 16
    q, kp, vp, bt, ln = _paged_inputs(7, B, B * PP + 2, PP, page, H, KV, hd)
    q, kp, vp = (_t(a, dtype, cuda) for a in (q, kp, vp))
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    got = ops.paged_decode_attention(q, kp, vp, bt, ln)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln)
    idx = bt.long().clamp(min=0)
    dense = ops.decode_attention(
        q, kp[idx].reshape(B, PP * page, KV, hd).contiguous(),
        vp[idx].reshape(B, PP * page, KV, hd).contiguous(), ln)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
    # one template, one order of operations: the two kernels agree exactly
    assert torch.equal(got, dense)
