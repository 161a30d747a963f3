"""The port's dense model against the JAX package's, on the CPU.

Layer functions take the same numpy inputs in both frameworks; whole
models take the JAX ``Model.init`` parameters through
``repro_torch.models.params_from_jax``.  Logits are compared at float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import Model as JModel
from repro.models import layers as jl
from repro_torch.configs import get
from repro_torch.kernels import ops
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.models import layers as tl

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _both(x, dtype="float32"):
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rms_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((2, 5, 64), np.float32), rng.standard_normal(64).astype(np.float32)
    (tx, jx), (tw, jw) = _both(x, dtype), _both(w, dtype)
    np.testing.assert_allclose(_np(tl.rms_norm(tx, tw)), _np(jl.rms_norm(jx, jw)), **tol)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32), np.float32)
    pos = np.arange(7)[None, :] + np.array([[0], [5]])
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("H,KV,window", [(4, 4, 0), (8, 2, 0), (4, 1, 16)])
def test_attention_full_and_flash_op_match_jax_layer(H, KV, window):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 40, H, 32), np.float32)
    k = rng.standard_normal((2, 40, KV, 32), np.float32)
    v = rng.standard_normal((2, 40, KV, 32), np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = jl.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window)
    np.testing.assert_allclose(
        _np(tl.attention_full(tq, tk, tv, causal=True, window=window)), _np(want), **F32)
    # the op the port's model calls in place of attention_full
    np.testing.assert_allclose(
        _np(ops.flash_attention(tq, tk, tv, causal=True, window=window)), _np(want),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (4, 1)])
def test_attention_decode_and_decode_op_match_jax_layer(H, KV):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, H, 32), np.float32)
    kc = rng.standard_normal((3, 48, KV, 32), np.float32)
    vc = rng.standard_normal((3, 48, KV, 32), np.float32)
    ln = np.array([1, 20, 48], np.int32)
    targs = [torch.from_numpy(a) for a in (q, kc, vc, ln)]
    want = jl.attention_decode(*(jnp.asarray(a) for a in (q, kc, vc, ln)))
    np.testing.assert_allclose(_np(tl.attention_decode(*targs)), _np(want), **F32)
    np.testing.assert_allclose(_np(ops.decode_attention(*targs)), _np(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_mlp_apply_matches_jax(mlp_type):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 64), np.float32)
    p = {"w_up": rng.standard_normal((64, 96), np.float32) / 8,
         "w_down": rng.standard_normal((96, 64), np.float32) / 10,
         "w_gate": rng.standard_normal((64, 96), np.float32) / 8}
    got = tl.mlp_apply(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                       mlp_type)
    want = jl.mlp_apply(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                        mlp_type)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# the two dense reductions of the serving path, at float32: qwen3-8b
# (H 4 over KV 2, qk_norm) and the stablelm reduction of tests/test_serving.py
CONFIGS = {
    "qwen3-8b": dict(num_layers=2, vocab_size=128, dtype="float32"),
    "stablelm-1.6b": dict(num_layers=2, vocab_size=128, dtype="float32",
                          attn_chunk_threshold=1 << 30),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 parity
    torch.backends.cudnn.allow_tf32 = False
    jcfg = jget(request.param).reduced(**CONFIGS[request.param])
    tcfg = get(request.param).reduced(**CONFIGS[request.param])
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, params_from_jax(np_params, tcfg, "cpu"), np_params


def test_params_from_jax_round_trips(pair):
    _, _, tm, tp, np_params = pair
    back = params_to_jax(tp, tm.cfg)
    flat_a, tree_a = jax.tree_util.tree_flatten(np_params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    assert len(tp["layers"]) == tm.cfg.num_layers


def test_prefill_decode_forward_match_jax(pair):
    jm, jp, tm, tp, _ = pair
    rng = np.random.default_rng(5)
    B, S, max_seq = 2, 24, 32
    toks = rng.integers(1, tm.cfg.vocab_size, (B, S)).astype(np.int32)

    j_last, j_cache = jax.jit(jm.prefill)(jp, jm.init_cache(B, max_seq),
                                          {"tokens": jnp.asarray(toks)})
    t_cache = tm.init_cache(B, max_seq)
    t_last, _ = tm.prefill(tp, t_cache, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(t_last), _np(j_last), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(t_cache[0]["k"][:, :, :S]),
                               _np(j_cache[0]["k"][:, :, :S]), rtol=1e-4, atol=1e-4)

    nxt = np.array(jnp.argmax(j_last, axis=-1), np.int32)
    lengths = np.full((B,), S, np.int32)
    j_dec, _ = jax.jit(jm.decode_step)(jp, j_cache, jnp.asarray(nxt), jnp.asarray(lengths))
    t_dec, _ = tm.decode_step(tp, t_cache, torch.from_numpy(nxt), torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(t_dec), _np(j_dec), rtol=1e-4, atol=1e-4)

    ext = np.concatenate([toks, nxt[:, None]], axis=1)
    j_full = jax.jit(jm.forward_train)(jp, {"tokens": jnp.asarray(ext)})
    t_full = tm.forward_train(tp, {"tokens": torch.from_numpy(ext)})
    np.testing.assert_allclose(_np(t_full), _np(j_full), rtol=1e-4, atol=1e-4)
    # and the port is consistent with itself: decode == full forward
    np.testing.assert_allclose(_np(t_dec), _np(t_full[:, -1]), rtol=1e-4, atol=1e-4)


def test_paged_decode_step_matches_dense_decode(pair):
    """decode_step_paged over a pool laid out through a block table gives
    the dense decode's logits."""
    _, _, tm, tp, _ = pair
    rng = np.random.default_rng(6)
    S, page = 21, 8
    toks = rng.integers(1, tm.cfg.vocab_size, (1, S)).astype(np.int32)
    dense = tm.init_cache(1, 32)
    tm.prefill(tp, dense, {"tokens": torch.from_numpy(toks)})
    pools = tm.init_cache(7, page)                      # 6 pages + scratch
    table = torch.tensor([[4, 1, 5, 0]], dtype=torch.int32)
    for stage, pool in zip(dense, pools):
        for name in pool:
            src = stage[name][:, 0].reshape(stage[name].shape[0], 4, page,
                                            *stage[name].shape[3:])
            pool[name][:, table[0].long()] = src
    tok = torch.tensor([7], dtype=torch.int32)
    length = torch.tensor([S], dtype=torch.int32)
    want, _ = tm.decode_step(tp, dense, tok, length)
    got = tm.decode_step_paged(tp, pools, tok, length, table,
                               torch.tensor([5]), torch.tensor([S % page]))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_unported_kinds_raise_naming_the_roadmap_item():
    for arch in ("xlstm-350m", "dbrx-132b", "hymba-1.5b", "deepseek-v3-671b",
                 "internvl2-76b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(get(arch).reduced(), device="cpu")
    swa = dataclasses.replace(get("qwen3-8b").reduced(), attn_type="swa", window=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(swa, device="cpu")
