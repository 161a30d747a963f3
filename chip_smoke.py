#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

  python3 chip_smoke.py        # from the repository root, on a machine with the card

Phases; any failure ends the run with a non-zero exit and no result line:

 1. Host facts: card name and power limit, torch / CUDA versions, nvcc,
    whether ``triton`` imports.
 2. Build: compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
    (into ``src/repro_torch/kernels/_build``) and prints each kernel's
    registers, shared memory and spills as ``nvcc -Xptxas -v`` reports them.
 3. Kernels: each kernel against its plain PyTorch version on the card, at
    the serving path's shapes (qwen3-8b: 32 heads over 8 KV heads, head_dim
    128, page 16, contexts up to max_seq 1024) and at a G = 1 / head_dim 64
    case, in float32 and bfloat16 (rtol = atol 2e-4 and 2e-2).  Times the
    kernel, the plain version and one PyTorch library call with CUDA events,
    L2 flushed before each launch, and computes each kernel's bound and
    achieved rate (GB/s for decode, TFLOP/s for flash); the slotted decode
    kernel also at B = 35, the capacity of the slotted chains in phase 4,
    and flash at S = 512 and 1024, the serving path's largest prefill
    buckets.  Asserts that one row decoded alone, inside a batch of 35 and
    through the paged kernel at a pow2 page count is bit-equal (the
    split-KV chunks sit at fixed positions), and that the dense kernel with
    a row map (``rows``, the pipeline's slotted addressing) is bit-equal to
    the kernel on the gathered rows; times the row map at B = 16 and 35 on
    a capacity-35 cache beside ``rows=None``.
 4. Serve: the port's serving entry point (launch/serve.py) at qwen3-8b
    full width in bfloat16 (random weights from a seed): 6 logical servers
    composed into chains, 16 requests with prompts of 100-600 tokens and 32
    new tokens each, max_seq 1024, once with the slotted and once with the
    paged KV layout; then through the pipeline engine (each chain's hops
    run as stages), slotted with 4 stages a chain and 2 microbatches, and
    paged with one stage per hop and 2 microbatches.  The slotted
    pipeline's peak device memory must stay within 1 GiB of the monolithic
    slotted run's (a gathered cache would add GBs).
    Launch counts are zeroed before and read after each run; the kernels
    line gives their sum as ``launches`` and each run's count under
    ``launches_by_layout``.  Prefill and
    decode logits of two prompts are held against ``forward_train`` over
    the extended sequence at the repo's bf16 tolerance (rtol = atol 6e-2,
    which tests/test_models_smoke.py applies to 4-layer configs): asserted
    on the model's first 4 layers, reported at all 36.
 5. Float32, TF32 off: the logits check of phase 4 at full width and
    depth (36 layers), held at rtol = atol 1e-3; then the same composition
    at full width and 4 layers, where the slotted and paged engines and
    the pipeline engine (slotted, 4 stages, 4 microbatches; paged, one
    stage per hop, 2 microbatches) must produce identical greedy streams.
    One more paged pipeline run fails a server after 40 decode rounds
    (``--fail-after``) and must serve every request; whether its streams
    equal the run without a failure is reported, not asserted (a
    re-prefill runs flash where the first pass decoded, so a near-tie may
    flip).

The last three lines are the ``{"kernels": [...]}`` JSON line, the card's
name and power limit as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16
              torch.float32: 67e12}        # float32 outside the tensor cores
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
BF16_MODEL_TOL = 6e-2                      # tests/test_models_smoke.py
F32_MODEL_TOL = 1e-3       # float32 at full depth; the CPU tests use 1e-4 at 2 layers
MAX_SEQ, PAGE = 1024, 16
SLOTTED_B = 35       # capacity of the slotted chains srv0 / srv3 in phase 4
PIPELINE_RUNS = {    # phase 4's pipeline runs: layout, stages a chain, microbatches
    "pipeline_slotted": ("slotted", 4, 2),
    "pipeline_paged": ("paged", None, 2),
}
MEMORY_SLACK = 1 << 30     # slotted pipeline peak vs monolithic slotted peak
FAIL_AFTER = 40            # phase 5's failover run
H, KV, HD = 32, 8, 128                     # qwen3-8b attention
SEED = 0
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:99",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:223",
    "flash_attention": "src/repro/kernels/flash_attention.py:127",
}
SOURCES = {
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "paged_decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phases 1-2
# ---------------------------------------------------------------------------

def host_facts() -> None:
    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"host: {nvidia_smi_line()} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | nvcc: {nvcc} | triton imports: {has_triton} | "
        f"python {sys.version.split()[0]}")


def build_kernels() -> None:
    t0 = time.perf_counter()
    build.library()
    log(f"build: {build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    name, spill = None, ""
    for line in build.ptxas_report().splitlines():
        m = re.search(r"(decode_chunk_kernel|decode_combine_kernel|flash_mma_kernel|"
                      r"flash_fma_kernel)I(.*?)EEv", line)
        if m:
            kind, args = m.groups()
            dtype = ("bf16" if "__nv_bfloat16" in args or kind == "flash_mma_kernel"
                     else "f32")
            ints = re.findall(r"Li(\d+)E", args)       # head_dim, then the group bound
            paged = re.search(r"Lb([01])", args)
            parts = [dtype, *(f"{key}{x}" for key, x in zip(("hd=", "G<="), ints)),
                     paged and ("paged" if paged.group(1) == "1" else "dense")]
            name = f"{kind}<{', '.join(p for p in parts if p)}>"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

class L2Flush:
    """Writes 64 MB (more than the 50 MB L2) before each timed launch, as
    the serving path finds each layer's cache cold."""

    def __init__(self):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush: L2Flush, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
        # keep the card busy while the host enqueues the launch, so the
        # interval holds device time and not the wrapper's host overhead
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def decode_inputs(B, S, h, kv, hd, dtype, gen):
    q = randn((B, h, hd), dtype, gen)
    k, v = randn((B, S, kv, hd), dtype, gen), randn((B, S, kv, hd), dtype, gen)
    lengths = torch.randint(100, 633, (B,), generator=gen, device="cuda")
    lengths[0], lengths[-1] = 1, S                 # length 1 and a full context
    return q, k, v, lengths.to(torch.int32)


def paged_inputs(B, h, kv, hd, dtype, gen):
    PP = MAX_SEQ // PAGE
    P = B * PP + 1
    q = randn((B, h, hd), dtype, gen)
    kp, vp = randn((P, PAGE, kv, hd), dtype, gen), randn((P, PAGE, kv, hd), dtype, gen)
    lengths = torch.randint(100, 633, (B,), generator=gen, device="cuda")
    lengths[0], lengths[-1] = 1, MAX_SEQ
    perm = torch.randperm(P - 1, generator=gen, device="cuda").to(torch.int32)
    bt = torch.full((B, PP), -1, dtype=torch.int32, device="cuda")
    for b in range(B):                              # scattered pages, -1 tails
        n = -(-int(lengths[b]) // PAGE)
        bt[b, :n] = perm[b * PP:b * PP + n]
    return q, kp, vp, bt, lengths.to(torch.int32)


def flash_inputs(B, S, h, kv, hd, dtype, gen):
    return (randn((B, S, h, hd), dtype, gen), randn((B, S, kv, hd), dtype, gen),
            randn((B, S, kv, hd), dtype, gen))


def check(name, got, want, dtype) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} ({dtype}): max abs err {err.max().item():.3e} "
                             f"outside rtol=atol={tol}")
    return err.max().item()


def sdpa_gqa(*args, **kw):
    return torch.nn.functional.scaled_dot_product_attention(*args, enable_gqa=True, **kw)


def bound(nbytes: int, flops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def finish(r: dict) -> dict:
    """Adds the bound and the achieved rate (GB/s for a record whose
    ``rate`` is "bytes", decode; TFLOP/s otherwise, flash) to a timing
    record; returns the numbers the kernels line keeps."""
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], r["dtype"])
    if r["rate"] == "bytes":
        r["achieved"] = f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s"
    else:
        r["achieved"] = f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s"
    return {key: r[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "achieved")}


def row_invariance(dtype, gen) -> None:
    """One row decoded alone over a shorter cache, inside a batch of
    SLOTTED_B at S = MAX_SEQ, and through the paged kernel at a pow2 page
    count: the split-KV chunks sit at fixed positions, so the three outputs
    must be bit-equal."""
    row, n = 5, 300
    q, k, v, ln = decode_inputs(SLOTTED_B, MAX_SEQ, H, KV, HD, dtype, gen)
    ln[row] = n
    batch = ops.decode_attention(q, k, v, ln)[row]
    alone = ops.decode_attention(q[row:row + 1].clone(), k[row:row + 1, :512].contiguous(),
                                 v[row:row + 1, :512].contiguous(), ln[row:row + 1].clone())[0]
    npages = -(-n // PAGE)
    PP = 1 << (npages - 1).bit_length()
    kp, vp = randn((4 * PP + 1, PAGE, KV, HD), dtype, gen), randn((4 * PP + 1, PAGE, KV, HD),
                                                                   dtype, gen)
    perm = torch.randperm(4 * PP, generator=gen, device="cuda").to(torch.int32)
    bt = torch.full((4, PP), -1, dtype=torch.int32, device="cuda")
    for r in range(4):
        bt[r, :npages] = perm[r * PP:r * PP + npages]
    pages = bt[2, :npages].long()
    kp[pages] = k[row, :npages * PAGE].reshape(npages, PAGE, KV, HD)
    vp[pages] = v[row, :npages * PAGE].reshape(npages, PAGE, KV, HD)
    lp = torch.tensor([17, 33, n, 250], dtype=torch.int32, device="cuda")
    paged = ops.paged_decode_attention(q[[row, 0, row, 1]].contiguous(), kp, vp, bt, lp)[2]
    torch.cuda.synchronize()
    if not (torch.equal(batch, alone) and torch.equal(batch, paged)):
        raise AssertionError(f"decode row invariance broken ({dtype})")
    log(f"  row invariance         {str(dtype):14s} length {n}: alone (S=512), in a batch "
        f"of {SLOTTED_B} (S={MAX_SEQ}) and paged (PP={PP}) bit-equal")


def rows_phase(dtype, gen, flush: L2Flush, timed: bool) -> dict:
    """The dense kernel with a row map over a capacity-SLOTTED_B cache (the
    slotted pipeline's addressing) against the same kernel on the gathered
    rows: bit-equal.  With ``timed``, the row map's time at B = 16 and 35
    beside ``rows=None`` on a cache of B rows."""
    out = {}
    _, k, v, _ = decode_inputs(SLOTTED_B, MAX_SEQ, H, KV, HD, dtype, gen)
    for B in (16, SLOTTED_B):
        q = randn((B, H, HD), dtype, gen)
        ln = torch.randint(100, 633, (B,), generator=gen, device="cuda").to(torch.int32)
        ln[0], ln[-1] = 1, MAX_SEQ
        rows = torch.randperm(SLOTTED_B, generator=gen, device="cuda")[:B].to(torch.int32)
        kg, vg = k[rows.long()].contiguous(), v[rows.long()].contiguous()
        got = ops.decode_attention(q, k, v, ln, rows)
        want = ops.decode_attention(q, kg, vg, ln)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"decode with rows differs from the gathered decode "
                                 f"({dtype}, B={B})")
        if timed:
            out[f"B{B}"] = dict(
                rows_ms=time_ms(lambda: ops.decode_attention(q, k, v, ln, rows), flush),
                none_ms=time_ms(lambda: ops.decode_attention(q, kg, vg, ln), flush))
        log(f"  decode rows            {str(dtype):14s} B={B} of a {SLOTTED_B}-row cache: "
            f"bit-equal to the gathered decode"
            + (f"; rows {out[f'B{B}']['rows_ms']:.4f} ms, rows=None "
               f"{out[f'B{B}']['none_ms']:.4f} ms" if timed else ""))
        del kg, vg
    return out


def time_decode(B, h, kv, hd, dtype, gen, flush: L2Flush) -> dict:
    """Times the slotted decode kernel, its plain version and
    scaled_dot_product_attention on one set of inputs of batch ``B``."""
    es = torch.empty((), dtype=dtype).element_size()
    q, k, v, ln = decode_inputs(B, MAX_SEQ, h, kv, hd, dtype, gen)
    tok = int(ln.sum())
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return dict(
        ms=time_ms(lambda: ops.decode_attention(q, k, v, ln), flush),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, k, v, ln), flush),
        library_ms=time_ms(lambda: sdpa_gqa(qt, kt, vt, attn_mask=mask), flush),
        bytes=2 * q.numel() * es + 2 * tok * kv * hd * es + 4 * B,
        flops=4 * h * hd * tok, dtype=dtype, rate="bytes")


def kernels_phase(flush: L2Flush) -> dict:
    """Correctness at every case; times and bounds at the serving shape in
    bfloat16.  Returns one record per kernel (launches filled in later)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = {}
    cases = [(torch.bfloat16, H, KV, HD), (torch.float32, H, KV, HD),
             (torch.bfloat16, 16, 16, 64), (torch.float32, 16, 16, 64)]
    for dtype, h, kv, hd in cases:
        main = dtype == torch.bfloat16 and h == H
        B = 16
        es = torch.empty((), dtype=dtype).element_size()

        # 1. decode over the slotted cache
        q, k, v, ln = decode_inputs(B, MAX_SEQ, h, kv, hd, dtype, gen)
        err = check("decode_attention", ops.decode_attention(q, k, v, ln),
                    ref.decode_attention_ref(q, k, v, ln), dtype)
        log(f"  decode_attention       {str(dtype):14s} B={B} S={MAX_SEQ} H={h} KV={kv} "
            f"hd={hd}: max abs err {err:.3e}")
        if main:
            records["decode_attention"] = dict(
                max_abs_err=err, **time_decode(B, h, kv, hd, dtype, gen, flush))
            at_cap = time_decode(SLOTTED_B, h, kv, hd, dtype, gen, flush)
            records["decode_attention"]["at_capacity"] = dict(B=SLOTTED_B, **finish(at_cap))
            log(f"  decode_attention at B={SLOTTED_B}: " + json.dumps(
                records["decode_attention"]["at_capacity"]))

        # 2. decode through the block table over the paged pool
        q, kp, vp, bt, ln = paged_inputs(B, h, kv, hd, dtype, gen)
        got = ops.paged_decode_attention(q, kp, vp, bt, ln)
        err = check("paged_decode_attention", got,
                    ref.paged_decode_attention_ref(q, kp, vp, bt, ln), dtype)
        idx = bt.long().clamp(min=0)
        dense = ops.decode_attention(
            q, kp[idx].reshape(B, -1, kv, hd).contiguous(),
            vp[idx].reshape(B, -1, kv, hd).contiguous(), ln)
        if not torch.equal(got, dense):
            raise AssertionError("paged and dense decode kernels disagree on the "
                                 "gathered cache")
        log(f"  paged_decode_attention {str(dtype):14s} B={B} page={PAGE} "
            f"PP={bt.shape[1]} H={h} KV={kv} hd={hd}: max abs err {err:.3e} "
            f"(bit-equal to the dense kernel on the gathered cache)")
        if h == H:
            row_invariance(dtype, gen)
            rows = rows_phase(dtype, gen, flush, timed=main)
            if main:
                records["decode_attention"]["rows"] = rows
        if main:
            tok = int(ln.sum())
            pages = int((-(-ln // PAGE)).sum())
            nbytes = 2 * q.numel() * es + 2 * tok * kv * hd * es + 4 * B + 4 * pages
            records["paged_decode_attention"] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, ln), flush),
                plain_ms=time_ms(
                    lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, ln), flush),
                library_ms=None, bytes=nbytes, flops=4 * h * hd * tok, dtype=dtype,
                rate="bytes")

        # 3. prefill: the 512- and 1024-token buckets of the serving path,
        #    plus a ragged length with a 128 window
        for S, window in ((512, 0), (1024, 0), (333, 128)):
            q, k, v = flash_inputs(1, S, h, kv, hd, dtype, gen)
            err = check("flash_attention",
                        ops.flash_attention(q, k, v, causal=True, window=window),
                        ref.flash_attention_ref(q, k, v, causal=True, window=window),
                        dtype)
            log(f"  flash_attention        {str(dtype):14s} B=1 S={S} window={window} "
                f"H={h} KV={kv} hd={hd}: max abs err {err:.3e}")
            if main and window == 0:
                pairs = S * (S + 1) // 2
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                rec = dict(
                    max_abs_err=err,
                    ms=time_ms(lambda: ops.flash_attention(q, k, v), flush),
                    plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), flush),
                    library_ms=time_ms(lambda: sdpa_gqa(qt, kt, vt, is_causal=True), flush),
                    # q and out (1, S, H, hd); k and v (1, S, KV, hd)
                    bytes=(2 * q.numel() + 2 * k.numel()) * es,
                    flops=4 * h * hd * pairs, dtype=dtype, rate="operations")
                if S == 512:
                    records["flash_attention"] = rec
                else:
                    records["flash_attention"]["at_s1024"] = dict(S=S, **finish(rec))
                    log(f"  flash_attention at S={S}: "
                        + json.dumps(records["flash_attention"]["at_s1024"]))
        del q, k, v
        torch.cuda.empty_cache()
    for name, r in records.items():
        finish(r)
        log(f"  {name}: kernel {r['ms']:.4f} ms ({r['achieved']}), plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']} B, "
            f"{r['flops']} flop)")
    return records


# ---------------------------------------------------------------------------
# Phases 4-5: serving through the composed chains
# ---------------------------------------------------------------------------

def serve_once(model, params, layout, max_new, parallelism="single", stages=None,
               micro=1, fail_after=0):
    orch = serve.orchestrator(model, params, n_servers=6, rate=2.0,
                              max_seq=MAX_SEQ, kv_layout=layout, parallelism=parallelism,
                              pipeline_stages=stages, microbatches=micro)
    reqs = serve.make_requests(SEED, 16, model.cfg.vocab_size, 100, 600, max_new, 2.0)
    chains = serve.describe(orch)
    if parallelism == "pipeline":
        two_hop = next((e for e in orch.engines if len(e.chain.blocks) > 1), None)
        if two_hop is not None and torch.cuda.device_count() >= 2:
            if len(set(two_hop.devices[:2])) != 2:
                raise AssertionError(f"two-hop chain stages share a card: {two_hop.devices}")
            chains.append(f"  {torch.cuda.device_count()} cards: the two-hop chain's "
                          f"stages run on {sorted(map(str, set(two_hop.devices)))}")
        else:
            chains.append(f"  {torch.cuda.device_count()} card(s): every stage runs on "
                          f"{orch.engines[0].devices[0]}")
    ops.reset_launches()
    summary = serve.run(orch, reqs, fail_after=fail_after)
    launches = dict(ops.LAUNCHES)
    del orch
    gc.collect()
    torch.cuda.empty_cache()
    return reqs, summary, launches, chains


def logits_agree(model, params, prompt, tol):
    """Prefill + one decode step against forward_train over the extended
    sequence.  Returns the largest absolute differences (prefill, decode)
    and whether both are within rtol = atol ``tol``."""
    tokens = torch.as_tensor(prompt[None], device="cuda")
    cache = model.init_cache(1, MAX_SEQ)
    last, _ = model.prefill(params, cache, {"tokens": tokens})
    nxt = torch.argmax(last, dim=-1).to(torch.int32)
    dec, _ = model.decode_step(params, cache, nxt,
                               torch.tensor([len(prompt)], dtype=torch.int32, device="cuda"))
    full = model.forward_train(params, {"tokens": torch.cat([tokens, nxt[:, None]], 1)})
    diffs, close = [], True
    for got, want in ((last, full[:, -2]), (dec, full[:, -1])):
        got, want = got.float(), want.float()
        if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
            raise AssertionError("non-finite logits")
        close &= torch.allclose(got, want, rtol=tol, atol=tol)
        diffs.append((got - want).abs().max().item())
    return diffs, close


def serve_phase() -> dict:
    cfg = serve.model_config("qwen3-8b")
    model = Model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"serve: qwen3-8b full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}) {cfg.dtype}; {cfg.total_param_count()} parameters "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    by_layout, peak = {}, {}
    runs = {"slotted": ("slotted", "single", None, 1),
            "paged": ("paged", "single", None, 1),
            **{name: (layout, "pipeline", stages, micro)
               for name, (layout, stages, micro) in PIPELINE_RUNS.items()}}
    for name, (layout, parallelism, stages, micro) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        reqs, summary, launches, chains = serve_once(model, params, layout, 32,
                                                     parallelism, stages, micro)
        peak[name] = torch.cuda.max_memory_allocated()
        for line in chains:
            log(f"  [{name}] {line}")
        bad = [r.rid for r in reqs if r.state.value != "done" or len(r.output) != 32]
        if bad:
            raise AssertionError(f"[{name}] requests not served in full: {bad}")
        # the monolithic slotted chains decode through the dense kernel, the
        # paged ones through the paged kernel (their admissions' boundary
        # fixups use the dense one); the slotted pipeline only the dense one
        if launches["flash_attention"] == 0 or launches["decode_attention"] == 0 or \
                (layout == "paged") != (launches["paged_decode_attention"] > 0):
            raise AssertionError(f"[{name}] kernels not on the path: {launches}")
        log(f"  [{name}] served {summary['finished']}/{summary['requests']} requests, "
            f"{summary['generated_tokens']} tokens in {summary['wall_s']:.3f} s wall "
            f"({summary['tokens_per_s']:.2f} tokens/s, {summary['rounds']} decode rounds), "
            f"max_memory_allocated {peak[name]} B, launches {launches}")
        by_layout[name] = launches
    over = peak["pipeline_slotted"] - peak["slotted"]
    log(f"  pipeline_slotted peak - slotted peak: {over} B (limit {MEMORY_SLACK} B)")
    if over > MEMORY_SLACK:
        raise AssertionError(f"slotted pipeline peak {peak['pipeline_slotted']} B exceeds "
                             f"the monolithic slotted peak {peak['slotted']} B by {over} B")
    # The repo holds prefill/decode logits to forward_train at its bf16
    # tolerance on 4-layer configs (tests/test_models_smoke.py); the check
    # is asserted at that depth (full width, the model's first 4 layers)
    # and measured at the full 36.
    prompts = serve.make_requests(SEED, 2, cfg.vocab_size, 100, 600, 32, 2.0)
    shallow = Model(dataclasses.replace(cfg, num_layers=4), "cuda")
    for depth, m, p in ((4, shallow, dict(params, layers=params["layers"][:4])),
                        (cfg.num_layers, model, params)):
        for r in prompts:
            (d_pre, d_dec), close = logits_agree(m, p, r.prompt, BF16_MODEL_TOL)
            log(f"  logits vs forward_train, bf16, {depth} layers, prompt of "
                f"{len(r.prompt)}: max abs diff prefill {d_pre:.4e}, decode "
                f"{d_dec:.4e} ({'within' if close else 'outside'} rtol=atol="
                f"{BF16_MODEL_TOL})")
            if depth == 4 and not close:
                raise AssertionError("prefill/decode logits off forward_train")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return by_layout


def f32_phase() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(serve.model_config("qwen3-8b"), dtype="float32")
    full = Model(cfg, "cuda")
    params = full.init(torch.Generator(device="cuda").manual_seed(SEED))
    # at full depth in float32, rounding cannot hide a fault of the path
    for r in serve.make_requests(SEED, 2, cfg.vocab_size, 100, 600, 32, 2.0):
        (d_pre, d_dec), close = logits_agree(full, params, r.prompt, F32_MODEL_TOL)
        log(f"f32: logits vs forward_train, {cfg.num_layers} layers, prompt of "
            f"{len(r.prompt)}: max abs diff prefill {d_pre:.4e}, decode {d_dec:.4e} "
            f"({'within' if close else 'outside'} rtol=atol={F32_MODEL_TOL})")
        if not close:
            raise AssertionError("float32 prefill/decode logits off forward_train")
    model = Model(dataclasses.replace(cfg, num_layers=4), "cuda")
    shallow = dict(params, layers=params["layers"][:4])
    streams = {}
    runs = {"slotted": ("slotted", "single", None, 1, 0),
            "paged": ("paged", "single", None, 1, 0),
            "pipeline_slotted": ("slotted", "pipeline", 4, 4, 0),
            "pipeline_paged": ("paged", "pipeline", None, 2, 0),
            "pipeline_paged_failover": ("paged", "pipeline", None, 2, FAIL_AFTER)}
    for name, (layout, parallelism, stages, micro, fail_after) in runs.items():
        reqs, summary, launches, _ = serve_once(model, shallow, layout, 32, parallelism,
                                                stages, micro, fail_after)
        if summary["finished"] != len(reqs) or \
                any(r.state.value != "done" or len(r.output) != 32 for r in reqs):
            raise AssertionError(f"[f32 {name}] {summary}")
        if fail_after and "failed_server" not in summary:
            raise AssertionError(f"[f32 {name}] no server failed: {summary}")
        streams[name] = [r.output for r in reqs]
        log(f"f32: [{name}] served {summary['finished']}/{summary['requests']}, "
            f"{summary['rounds']} decode rounds"
            + (f", server {summary['failed_server']} failed at round "
               f"{summary['failed_at_round']}: {summary['requeued']} re-queued, "
               f"{summary['chains_after']} chains after" if fail_after else ""))
    for name in ("paged", "pipeline_slotted", "pipeline_paged"):
        if streams[name] != streams["slotted"]:
            diff = [i for i, (a, b) in enumerate(zip(streams["slotted"], streams[name]))
                    if a != b]
            raise AssertionError(f"f32 {name} streams differ from slotted for requests {diff}")
    log(f"f32: qwen3-8b full width, 4 layers, float32, TF32 off: slotted == paged == "
        f"pipeline slotted (4 stages, 4 microbatches) == pipeline paged (per hop, 2 "
        f"microbatches) greedy streams for all {len(streams['paged'])} requests "
        f"({sum(map(len, streams['paged']))} tokens)")
    same = [a == b for a, b in zip(streams["pipeline_paged_failover"],
                                   streams["pipeline_paged"])]
    log(f"f32: failover run (server failed after {FAIL_AFTER} rounds): streams equal the "
        f"run without a failure for {sum(same)}/{len(same)} requests (reported, not "
        f"asserted)")
    del params, shallow, model, full
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    host_facts()
    build_kernels()
    log("kernels:")
    records = kernels_phase(L2Flush())
    by_layout = serve_phase()
    f32_phase()
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name],
         "launches": sum(counts[name] for counts in by_layout.values()),
         "launches_by_layout": {layout: counts[name]
                                for layout, counts in by_layout.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "achieved": r["achieved"],
         **{key: r[key] for key in ("at_capacity", "at_s1024", "rows") if key in r}}
        for name, r in records.items()]}
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps(line))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
