"""The live execution plane: run one :class:`ExperimentSpec` on the serving
system.

A *plane* is anything with ``name`` and
``run(spec, *, arrivals=None, controller=None) -> RunReport``.
:class:`LivePlane` is a :class:`repro_torch.serving.Orchestrator` stepping
decode rounds over mock or torch chain engines, driven by
:func:`drive_orchestrator` (with idle fast-forward).  The plane resolves
workload, seeds, classes, admission and autoscaling from the spec's fields
exactly as the JAX package's planes do, so a spec gives the same arrival
trace, the same events and the same :class:`RunReport` schema in both
packages.

``arrivals=`` overrides the spec's generated workload with a pre-built
trace; ``controller=`` injects an existing stateful controller instead of
building one from ``spec.autoscale``.

A copy of the live half of the JAX package's ``api/planes.py``:
``engine="torch"`` takes the place of ``engine="jax"`` and puts the port's
chain engines (``ChainEngine``, ``PagedChainEngine``,
``PipelineChainEngine``) behind the orchestrator, on the model's device.
The sim plane is ROADMAP queue 1, item 9; ``trace=True`` needs the flight
recorder, item 13.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.scenarios import Scenario, _resolve_arrivals
from repro_torch.core.workload import AZURE_STATS

from .registry import PLANES, WORKLOADS
from .report import RunReport, report_from_orchestrator
from .spec import ExperimentSpec, SpecError


def _coerce_arrivals(arrivals):
    """Normalize an explicit-arrivals override: column-array tuples pass
    through; the scalar engine's row form ``[(time, work, in_tokens,
    out_tokens[, cls]), ...]`` (list OR tuple of rows) converts to column
    arrays.  The discriminator matches the old ``simulate_vectorized``
    rule: a tuple whose first element is an ndarray is columns, anything
    else sequence-like is rows."""
    if arrivals is None:
        return None
    if isinstance(arrivals, tuple) \
            and (len(arrivals) == 0
                 or isinstance(arrivals[0], np.ndarray)):
        return arrivals
    if isinstance(arrivals, (list, tuple, np.ndarray)):
        if len(arrivals) == 0:
            return (np.empty(0), np.empty(0))
        if not all(hasattr(row, "__len__") and len(row) >= 2
                   for row in arrivals):
            raise SpecError(
                "arrivals",
                "rows must be (time, work[, in_tokens, out_tokens[, cls]]) "
                "tuples; for column arrays pass a tuple of numpy arrays")
        cols = list(zip(*arrivals))
        out = [np.asarray(cols[0], dtype=np.float64),
               np.asarray(cols[1], dtype=np.float64)]
        for c in cols[2:4]:
            out.append(np.asarray(c, dtype=np.int64))
        if len(cols) > 4:
            out.append(np.asarray(cols[4], dtype=np.int64))
        return tuple(out)
    raise SpecError("arrivals",
                    f"expected an arrivals tuple or tuple list, got "
                    f"{type(arrivals).__name__}")


def _resolve_workload(spec: ExperimentSpec, scenario: Scenario,
                      arrivals_override=None):
    """The spec's arrival trace: the explicit override when given, else the
    registry generator's output (``None`` = scenario-generated, resolved
    downstream by ``_resolve_arrivals``)."""
    if arrivals_override is not None:
        return _coerce_arrivals(arrivals_override)
    gen = WORKLOADS.get(spec.workload.generator)
    return gen(spec.workload, scenario, spec.workload_seed())


def _resolve_controller(spec: ExperimentSpec, controller):
    if controller is not None:
        return controller
    if spec.autoscale is not None:
        return spec.autoscale.build_controller()
    return None


def drive_orchestrator(orch, scenario, requests, dt: float = 1.0,
                       max_rounds: int = 100_000) -> dict:
    """Drive decode rounds while firing the scenario's cluster events.

    ``requests`` is a list of ``Request`` (all submitted at t=0) or of
    ``(time, Request)`` pairs.  Each round advances time by ``dt``, applies
    due events, submits due requests, steps every engine, and re-admits
    from the queue.  When the system is completely idle (no queued,
    deferred, draining or in-flight work, and no step hooks observing the
    clock), time **fast-forwards** to the next due event / arrival /
    warm-up deadline instead of spinning ``dt`` at a time — sparse traces
    cost what their events cost, not their silences (skipped rounds are
    counted in ``idle_skipped``; ``rounds`` stays on the ``t = rounds*dt``
    grid so event timing is unchanged).  Returns a summary with the
    applied-event log merged into ``orch.stats()``.
    """
    from repro_torch.serving.request import Request

    timed: List[Tuple[float, object]] = []
    for item in requests:
        if isinstance(item, Request):
            timed.append((0.0, item))
        else:
            timed.append((float(item[0]), item[1]))
    timed.sort(key=lambda p: p[0])
    pending = deque(scenario.cluster_events())
    applied: List[dict] = []
    next_req = 0
    rounds = 0
    idle_skipped = 0
    t = 0.0
    while rounds < max_rounds:
        t = rounds * dt
        while pending and pending[0].time <= t:
            applied.append(orch.apply_scenario_event(pending.popleft(), t))
        while next_req < len(timed) and timed[next_req][0] <= t:
            orch.submit(timed[next_req][1], t)
            next_req += 1
        orch.step(t)
        while orch.queue:                    # admit whenever capacity frees
            if not orch._dispatch(orch.queue.peek(), t):
                break
            orch.queue.pop()
        rounds += 1
        if (next_req >= len(timed) and not pending and not orch.queue
                and not orch.deferred and not orch.draining
                and not any(e.requests for e in orch.engines)):
            break
        # ---- idle fast-forward: nothing can happen until the next due
        # time, and no step hook is watching the clock — jump there.
        if (not orch.step_hooks and not orch.queue and not orch.deferred
                and not orch.draining
                and not any(e.requests for e in orch.engines)):
            t_due = math.inf
            if pending:
                t_due = min(t_due, pending[0].time)
            if next_req < len(timed):
                t_due = min(t_due, timed[next_req][0])
            if orch.warming:
                t_due = min(t_due, min(orch.warming.values()))
            if t_due is not math.inf:
                k = int(t_due // dt)
                while k * dt < t_due:        # exact: first grid point >= due
                    k += 1
                if k > rounds:
                    idle_skipped += k - rounds
                    rounds = k
    return {"rounds": rounds, "idle_skipped": idle_skipped,
            "events": applied, **orch.stats()}


class LivePlane:
    """The serving execution plane: a live ``Orchestrator`` over mock or
    torch chain engines.

    The spec's workload resolves to the *same* ``(times, works, classes)``
    trace as in the JAX package (same seed rule); each arrival becomes a
    ``Request`` whose decode length scales with its work
    (``max_new_tokens = round(work * tokens_per_work)``), so service-demand
    heterogeneity survives the plane switch.  ``engine="torch"`` runs the
    port's chain engines over ``model`` / ``params`` on the model's device
    (the card unless the model was built with ``device="cpu"``).
    """

    name = "live"

    def __init__(self, engine: str = "mock", dt: float = 0.5,
                 max_rounds: int = 100_000, prompt_tokens: int = 8,
                 tokens_per_work: float = 6.0, max_seq: int = 256,
                 kv_layout: str = "slotted", page_size: int = 16,
                 oversubscribe: float = 1.0, parallelism: str = "single",
                 pipeline_stages: Optional[int] = None, microbatches: int = 1,
                 model=None, params=None):
        if engine not in ("mock", "torch"):
            raise ValueError("engine must be 'mock' or 'torch'")
        if engine == "torch" and (model is None or params is None):
            raise ValueError("engine='torch' needs model= and params=")
        if kv_layout not in ("slotted", "paged"):
            raise SpecError("plane.kv_layout",
                            f"must be 'slotted' or 'paged', got {kv_layout!r}")
        page_size = int(page_size)
        if page_size < 1 or (page_size & (page_size - 1)):
            raise SpecError("plane.page_size",
                            f"must be a power of two, got {page_size}")
        if int(max_seq) % page_size:
            raise SpecError("plane.page_size",
                            f"must divide max_seq {max_seq}, got {page_size}")
        if float(oversubscribe) < 1.0:
            raise SpecError("plane.oversubscribe",
                            f"must be >= 1.0, got {oversubscribe}")
        if parallelism not in ("single", "pipeline"):
            raise SpecError(
                "plane.parallelism",
                f"must be 'single' or 'pipeline', got {parallelism!r}")
        if int(microbatches) < 1:
            raise SpecError("plane.microbatches",
                            f"must be >= 1, got {microbatches}")
        if pipeline_stages is not None and int(pipeline_stages) < 1:
            raise SpecError("plane.pipeline_stages",
                            f"must be >= 1 (or None for one stage per "
                            f"chain hop), got {pipeline_stages}")
        if parallelism == "single" and (int(microbatches) != 1
                                        or pipeline_stages is not None):
            raise SpecError(
                "plane.parallelism",
                "microbatches/pipeline_stages require parallelism='pipeline'")
        self.engine = engine
        self.dt = float(dt)
        self.max_rounds = int(max_rounds)
        self.prompt_tokens = int(prompt_tokens)
        self.tokens_per_work = float(tokens_per_work)
        self.max_seq = int(max_seq)
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.oversubscribe = float(oversubscribe)
        self.parallelism = parallelism
        self.pipeline_stages = (None if pipeline_stages is None
                                else int(pipeline_stages))
        self.microbatches = int(microbatches)
        self.model = model
        self.params = params

    def store_key(self) -> Optional[str]:
        """Results-store identity: the constructor knobs all shape the
        outcome, so they are part of the key.  Runs over a user-supplied
        model/params (the torch engine) are not reproducible from the spec
        alone — those return ``None``."""
        if self.model is not None or self.params is not None:
            return None
        return (f"{self.name}:engine={self.engine}:dt={self.dt:g}"
                f":max_rounds={self.max_rounds}"
                f":prompt_tokens={self.prompt_tokens}"
                f":tokens_per_work={self.tokens_per_work:g}"
                f":max_seq={self.max_seq}"
                f":kv_layout={self.kv_layout}:page_size={self.page_size}"
                f":oversubscribe={self.oversubscribe:g}"
                f":parallelism={self.parallelism}"
                f":pipeline_stages={self.pipeline_stages}"
                f":microbatches={self.microbatches}")

    def to_dict(self) -> dict:
        """JSON-serializable plane configuration (model/params excluded —
        they are runtime objects; :meth:`from_dict` re-attaches them)."""
        return {"plane": self.name, "engine": self.engine, "dt": self.dt,
                "max_rounds": self.max_rounds,
                "prompt_tokens": self.prompt_tokens,
                "tokens_per_work": self.tokens_per_work,
                "max_seq": self.max_seq, "kv_layout": self.kv_layout,
                "page_size": self.page_size,
                "oversubscribe": self.oversubscribe,
                "parallelism": self.parallelism,
                "pipeline_stages": self.pipeline_stages,
                "microbatches": self.microbatches}

    @classmethod
    def from_dict(cls, d: dict, model=None, params=None) -> "LivePlane":
        d = dict(d)
        plane = d.pop("plane", cls.name)
        if plane != cls.name:
            raise SpecError("plane", f"expected {cls.name!r}, got {plane!r}")
        unknown = set(d) - {"engine", "dt", "max_rounds", "prompt_tokens",
                            "tokens_per_work", "max_seq", "kv_layout",
                            "page_size", "oversubscribe", "parallelism",
                            "pipeline_stages", "microbatches"}
        if unknown:
            raise SpecError("plane", f"unknown fields: {sorted(unknown)}")
        return cls(model=model, params=params, **d)

    def _build_orchestrator(self, spec: ExperimentSpec):
        from repro_torch.serving import (
            Orchestrator, OrchestratorConfig, PagedChainEngine,
            PipelineChainEngine,
        )
        from repro_torch.serving.mock import MockEngine

        factory = None                       # the orchestrator's ChainEngine
        if self.engine == "mock":
            # the mock engine has no KV cache; kv_layout shapes torch runs only
            factory = MockEngine
        elif self.parallelism == "pipeline":
            factory = partial(PipelineChainEngine, kv_layout=self.kv_layout,
                              page_size=self.page_size,
                              oversubscribe=self.oversubscribe,
                              num_stages=self.pipeline_stages,
                              microbatches=self.microbatches)
        elif self.kv_layout == "paged":
            factory = partial(PagedChainEngine, page_size=self.page_size,
                              oversubscribe=self.oversubscribe)
        cfg = OrchestratorConfig(
            rho_bar=spec.cluster.rho_bar,
            tuner=spec.cluster.tuner,
            max_seq=self.max_seq,
            engine_factory=factory,
            classes=tuple(spec.workload.classes) or None,
            aging_rate=spec.policy.aging_rate,
        )
        return Orchestrator(list(spec.cluster.servers), spec.cluster.service,
                            self.model, self.params,
                            spec.workload.resolved_base_rate(), cfg)

    def _requests(self, spec: ExperimentSpec, times, works, cls_ids):
        from repro_torch.serving import Request

        max_new_cap = max(1, self.max_seq - self.prompt_tokens - 1)
        prompt = np.ones(self.prompt_tokens, np.int32)
        reqs = []
        for i, (t, w) in enumerate(zip(times, works)):
            n_new = max(1, min(max_new_cap,
                               int(round(float(w) * self.tokens_per_work))))
            reqs.append((float(t), Request(
                rid=i, prompt=prompt.copy(), max_new_tokens=n_new,
                arrival_time=float(t),
                cls=int(cls_ids[i]) if cls_ids is not None else 0)))
        return reqs

    def run(self, spec: ExperimentSpec, *, arrivals=None,
            controller=None, trace: bool = False) -> RunReport:
        if trace:
            raise NotImplementedError(
                "trace=True needs the flight recorder (obs/trace.py, "
                "decode.py, export.py), which is not ported yet: ROADMAP "
                "queue 1, item 13")
        if spec.cluster.job_servers:
            raise SpecError("cluster.job_servers",
                            "the live plane needs physical servers "
                            "(cluster.servers) to compose engines over")
        if self.parallelism == "pipeline" and self.engine != "torch":
            raise SpecError(
                "plane.parallelism",
                "pipeline parallelism needs engine='torch' (the mock engine "
                "has no block stack to split into stages)")
        if spec.policy.name not in ("jffc", "priority"):
            # the orchestrator's online dispatch IS JFFC over a central
            # (priority) queue — silently running a different-named policy
            # would report a comparison that never happened
            raise SpecError(
                "policy.name",
                f"{spec.policy.name!r} has no live-plane implementation "
                f"(the orchestrator dispatches jffc/priority); it needs the "
                f"sim plane (ROADMAP queue 1, item 9)")
        scenario = spec.scenario.to_scenario()
        arr = _resolve_workload(spec, scenario, arrivals)
        times, works, cls_ids = _resolve_arrivals(
            scenario, spec.workload.resolved_base_rate(),
            spec.workload_seed(), arr, spec.workload.service_model,
            spec.workload.trace_stats or AZURE_STATS,
            spec.workload.class_rates)
        orch = self._build_orchestrator(spec)
        orch.set_admission_level(spec.admission.level)
        ctl = _resolve_controller(spec, controller)
        if ctl is not None:
            ctl.bind_orchestrator(orch)
        reqs = self._requests(spec, times, works, cls_ids)
        summary = drive_orchestrator(orch, scenario, reqs, dt=self.dt,
                                     max_rounds=self.max_rounds)
        summary["n_jobs"] = len(reqs)
        cost = None
        extras = {}
        if ctl is not None:
            t_end = summary["rounds"] * self.dt
            ctl.bill(t_end, len(orch.servers))
            ctl.finalize(t_end)
            rts = np.asarray([r.response_time() for r in orch.finished
                              if r.response_time() is not None])
            cost = ctl.report(rts, final_servers=len(orch.servers)).as_dict()
            extras["scaling_records"] = [dataclasses.asdict(r)
                                         for r in ctl.records]
            extras["controller"] = ctl
        extras["orchestrator"] = orch
        return report_from_orchestrator(spec, orch, summary, self.dt,
                                        plane=self.name, cost=cost,
                                        extras=extras)


PLANES.register("live", LivePlane)
