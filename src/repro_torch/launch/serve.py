"""End-to-end serving entry point of the port: composes server chains (GBP-CR +
GCA + tuned c*), starts the JFFC orchestrator, and serves synthetic
requests through the chain engines on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --requests 16 --max-seq 1024 --kv-layout paged
  PYTHONPATH=src python -m repro_torch.launch.serve --parallelism pipeline \\
      --pipeline-stages 4 --microbatches 2

Weights are random, drawn from ``--seed``; nothing is downloaded.  The
logical servers are heterogeneous as in the JAX package's launch/serve.py: their
memory and latency coefficients (tau_c, tau_p) are the control plane's
*modelled* service times, which shape the composition and the simulated
clock — they are not measurements of the card.  With ``--parallelism
single`` every chain engine runs its whole layer stack on the device given
by ``--device``; with ``pipeline`` each chain runs as pipeline stages
(``--pipeline-stages``, one per hop by default) over ``--microbatches``
microbatches, its stages placed round-robin on the visible cards.
``--fail-after N`` fails the first chain's first server after N decode
rounds (the failover path: its requests are re-queued and the chains
recomposed).
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.configs.base import ModelConfig
from repro_torch.core import Server, ServiceSpec
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving import (
    ChainEngine,
    Orchestrator,
    OrchestratorConfig,
    PagedChainEngine,
    PipelineChainEngine,
    Request,
    service_spec_for,
)

KV_LAYOUTS = ("slotted", "paged")
PARALLELISM = ("single", "pipeline")


def model_config(arch: str, reduced: bool = False) -> ModelConfig:
    """The registry config, optionally reduced."""
    cfg = get(arch)
    return cfg.reduced() if reduced else cfg


def build_servers(cfg: ModelConfig, spec: ServiceSpec, n: int) -> List[Server]:
    """``n`` logical servers: every third is fast (1.3x the model's weight
    memory, tau_p 0.01 s/block), the rest slow (0.8x, 0.02 s/block); each
    also holds 8 slots of cache for every block.  Modelled coefficients."""
    model_gb = spec.block_size_gb * cfg.num_layers
    servers = []
    for i in range(n):
        fast = i % 3 == 0
        mem = (model_gb * (1.3 if fast else 0.8)
               + spec.cache_size_gb * cfg.num_layers * 8)
        servers.append(Server(f"srv{i}", mem, 0.02 + 0.01 * (i % 2),
                              0.01 if fast else 0.02))
    return servers


def make_requests(seed: int, n: int, vocab: int, prompt_len: int,
                  prompt_len_max: int, max_new: int, rate: float
                  ) -> List[Request]:
    """Poisson arrivals at ``rate``; prompt lengths uniform in
    ``[prompt_len, prompt_len_max]``; random token ids."""
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for rid in range(n):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.integers(prompt_len, prompt_len_max + 1))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(1, vocab, plen).astype(np.int32),
            max_new_tokens=max_new, arrival_time=t))
    return reqs


def engine_factory(kv_layout: str, parallelism: str = "single",
                   pipeline_stages: Optional[int] = None, microbatches: int = 1):
    """The chain-engine class (or pipeline partial) the orchestrator builds
    each composed chain with."""
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
    if parallelism not in PARALLELISM:
        raise ValueError(f"parallelism must be one of {PARALLELISM}, "
                         f"got {parallelism!r}")
    if parallelism == "pipeline":
        return functools.partial(PipelineChainEngine, kv_layout=kv_layout,
                                 num_stages=pipeline_stages,
                                 microbatches=microbatches)
    if pipeline_stages is not None or microbatches != 1:
        raise ValueError("pipeline_stages and microbatches need "
                         "parallelism='pipeline'")
    return ChainEngine if kv_layout == "slotted" else PagedChainEngine


def orchestrator(model: Model, params, n_servers: int, rate: float,
                 max_seq: int, kv_layout: str, parallelism: str = "single",
                 pipeline_stages: Optional[int] = None,
                 microbatches: int = 1) -> Orchestrator:
    spec = service_spec_for(model.cfg, max_seq=max_seq)
    servers = build_servers(model.cfg, spec, n_servers)
    factory = engine_factory(kv_layout, parallelism, pipeline_stages, microbatches)
    return Orchestrator(servers, spec, model, params, rate,
                        OrchestratorConfig(max_seq=max_seq, engine_factory=factory))


def describe(orch: Orchestrator) -> List[str]:
    lines = [f"composed {len(orch.engines)} chains (c*={orch.c_star}):"]
    for e in orch.engines:
        line = (f"  chain {list(e.chain.servers)} blocks/hop={list(e.chain.blocks)}"
                f" capacity={e.capacity} T_k={e.chain.service_time:.3f}s"
                f" kv_bytes={e.kv_bytes}")
        if isinstance(e, PipelineChainEngine):
            line += " stages=" + " ".join(
                f"[{sp.lo},{sp.hi})@{dev}" for sp, dev in zip(e.plan, e.devices))
        lines.append(line)
    return lines


def _sync(orch: Orchestrator) -> None:
    """Wait for every card the engines run on."""
    if any(e.device.type == "cuda" for e in orch.engines):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def run(orch: Orchestrator, requests: Sequence[Request], dt: float = 0.05,
        max_rounds: int = 100_000, fail_after: int = 0) -> Dict[str, float]:
    """Submit each request at its arrival time on a simulated clock that
    advances ``dt`` per decode round; run rounds until all are served.
    ``fail_after=N`` fails the first chain's first server after N rounds
    (when another server is left), as the JAX package's launch/serve.py
    does."""
    pending = sorted(requests, key=lambda r: r.arrival_time)
    now, rounds = 0.0, 0
    failover: Dict[str, object] = {}
    _sync(orch)
    t0 = time.perf_counter()
    while pending or orch.queue or any(e.requests for e in orch.engines):
        now += dt
        while pending and pending[0].arrival_time <= now:
            orch.submit(pending.pop(0), now)
        orch.step(now)
        rounds += 1
        if fail_after and rounds == fail_after and len(orch.servers) > 1:
            victim = orch.engines[0].chain.servers[0]
            n = orch.fail_server(victim, now)
            failover = {"failed_server": victim, "failed_at_round": rounds,
                        "requeued": n, "chains_after": len(orch.engines)}
            print(f"!! server {victim} failed at round {rounds}: {n} requests "
                  f"re-queued, recomposed to {len(orch.engines)} chains")
        if rounds >= max_rounds:
            raise RuntimeError(f"not served within {max_rounds} decode rounds")
    _sync(orch)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in requests)
    return {"requests": len(requests), "finished": len(orch.finished),
            "generated_tokens": tokens, "rounds": rounds, "wall_s": wall,
            "tokens_per_s": tokens / wall if wall > 0 else float("nan"),
            **failover}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-layout", choices=KV_LAYOUTS, default="slotted")
    ap.add_argument("--parallelism", choices=PARALLELISM, default="single")
    ap.add_argument("--pipeline-stages", type=int, default=None,
                    help="stages per chain (pipeline; default one per hop)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="microbatches per decode round (pipeline)")
    ap.add_argument("--fail-after", type=int, default=0,
                    help="fail a server after N decode rounds (failover)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--servers", type=int, default=6)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=100)
    ap.add_argument("--prompt-len-max", type=int, default=600)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.arch, args.reduced)
    model = Model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    orch = orchestrator(model, params, args.servers, args.rate, args.max_seq,
                        args.kv_layout, args.parallelism, args.pipeline_stages,
                        args.microbatches)
    print("\n".join(describe(orch)))
    reqs = make_requests(args.seed, args.requests, cfg.vocab_size,
                         args.prompt_len, args.prompt_len_max, args.max_new,
                         args.rate)
    summary = run(orch, reqs, fail_after=args.fail_after)
    print(f"served {summary['finished']} requests, "
          f"{summary['generated_tokens']} tokens in {summary['wall_s']:.2f}s wall "
          f"({summary['tokens_per_s']:.1f} tokens/s, {summary['rounds']} decode rounds, "
          f"{orch.recompositions} compositions)")
    rts = [r.response_time() for r in orch.finished]
    print(f"response time (simulated s): mean {np.mean(rts):.2f}  "
          f"p95 {np.percentile(rts, 95):.2f}")
    return summary


if __name__ == "__main__":
    main()
