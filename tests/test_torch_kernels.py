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
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import CHUNK

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


def _split_kv_decode(q, k, v, lengths, chunk):
    """The decode kernel's algebra in plain torch: each chunk of ``chunk``
    positions at fixed boundaries keeps its own (m, l, acc); a chunk at or
    past the length contributes nothing; the chunks merge in chunk order by
    the log-sum-exp rule; out = acc / max(l, 1e-30)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2).float()
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = int(lengths[b])
        parts = []
        for c in range(-(-S // chunk)):
            lo, hi = c * chunk, min((c + 1) * chunk, n)
            if lo >= hi:
                continue
            s = torch.einsum("hd,shd->hs", q[b].float(), kk[b, lo:hi]) / math.sqrt(hd)
            m = s.max(dim=1).values
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(dim=1), torch.einsum("hs,shd->hd", p, vv[b, lo:hi])))
        big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        w = [torch.exp(m - big_m) for m, _, _ in parts]
        l = sum(l_c * w_c for (_, l_c, _), w_c in zip(parts, w))
        acc = sum(a_c * w_c[:, None] for (_, _, a_c), w_c in zip(parts, w))
        out[b] = acc / l.clamp_min(1e-30)[:, None]
    return out


# (chunk, S, lengths): the kernel's chunk with a length on a chunk boundary,
# one past it, one short of it and empty trailing chunks; a smaller chunk
# with ragged and boundary lengths
SPLIT_CASES = [
    (CHUNK, 640, [1, CHUNK - 1, CHUNK, CHUNK + 1, 640]),
    (64, 200, [64, 1, 130, 200]),
]


@pytest.mark.parametrize("chunk,S,lengths", SPLIT_CASES)
def test_split_kv_combine_matches_plain_and_jax_oracle(jx, chunk, S, lengths):
    q, kc, vc, ln = _decode_inputs(12, len(lengths), S, 4, 2, 32, lengths)
    got = _split_kv_decode(*(torch.from_numpy(a) for a in (q, kc, vc)), ln, chunk)
    plain = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, kc, vc, ln)))
    oracle = jx.ref.decode_attention_ref(*(jx.jnp.asarray(a) for a in (q, kc, vc, ln)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(oracle), rtol=1e-5, atol=1e-5)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,H,KV,hd", GPU_HEADS)
def test_cuda_decode_chunk_edges(cuda, dtype, H, KV, hd):
    """Lengths on either side of the split-KV chunk boundary and the full
    cache."""
    S = 1024
    lengths = [1, CHUNK - 1, CHUNK, CHUNK + 1, S]
    q, kc, vc, ln = _decode_inputs(8, len(lengths), S, H, KV, hd, lengths)
    args = [_t(a, dtype, cuda) for a in (q, kc, vc)]
    lengths = torch.from_numpy(ln).to(cuda)
    got = ops.decode_attention(*args, lengths)
    want = ref.decode_attention_ref(*args, lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_row_invariance(cuda, dtype):
    """A row's output depends only on its own query, cache and length: alone
    over a shorter cache, inside a batch of 35 at S = 1024, and through the
    paged kernel at a pow2 page count, the results are bit-equal."""
    B, S, H, KV, hd, page, row, n = 35, 1024, 32, 8, 128, 16, 5, 300
    rng = np.random.default_rng(9)
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    lengths[row] = n
    q, kc, vc, ln = _decode_inputs(9, B, S, H, KV, hd, lengths)
    q, kc, vc = (_t(a, dtype, cuda) for a in (q, kc, vc))
    ln = torch.from_numpy(ln).to(cuda)
    batch = ops.decode_attention(q, kc, vc, ln)[row]
    alone = ops.decode_attention(q[row:row + 1].clone(), kc[row:row + 1, :512].contiguous(),
                                 vc[row:row + 1, :512].contiguous(), ln[row:row + 1].clone())[0]
    # the row's pages scattered over a pool; 4 rows (pow2), 32 pages (pow2)
    PP, npages = 32, -(-n // page)
    perm = torch.from_numpy(rng.permutation(4 * PP)).to(cuda)
    kp = torch.randn(4 * PP + 1, page, KV, hd, device=cuda).to(q.dtype)
    vp = torch.randn(4 * PP + 1, page, KV, hd, device=cuda).to(q.dtype)
    bt = torch.full((4, PP), -1, dtype=torch.int32, device=cuda)
    for r in range(4):
        bt[r, :npages] = perm[r * PP:r * PP + npages].to(torch.int32)
    pages = bt[2, :npages].long()
    kp[pages] = kc[row, :npages * page].reshape(npages, page, KV, hd)
    vp[pages] = vc[row, :npages * page].reshape(npages, page, KV, hd)
    qp = q[[row, 0, row, 1]].contiguous()
    lp = torch.tensor([17, 33, n, 250], dtype=torch.int32, device=cuda)
    paged = ops.paged_decode_attention(qp, kp, vp, bt, lp)[2]
    torch.cuda.synchronize()
    assert torch.equal(batch, alone)
    assert torch.equal(batch, paged)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,hd", [(32, 8, 128), (8, 8, 64), (4, 2, 32)])
def test_cuda_flash_serving_shapes(cuda, dtype, H, KV, hd):
    """A ragged length with a 128 window, and the serving path's largest
    prefill bucket (S = 1024)."""
    for S, window in ((333, 128), (1024, 0)):
        q, k, v = (_t(a, dtype, cuda) for a in _qkv(10, 1, S, H, KV, hd))
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **TOL[dtype])
