"""Serving layer: live orchestrator, chain engines (monolithic and
pipeline-parallel, and a model-free mock) and KV caches."""
from .engine import ChainEngine, PagedChainEngine
from .kv_cache import (
    PAGE_SIZE,
    PageAccounting,
    PagedCache,
    SlotCache,
    service_spec_for,
)
from .mock import MockEngine, mock_orchestrator
from .orchestrator import Orchestrator, OrchestratorConfig
from .pipeline import PipelineChainEngine, StageSpec, plan_stages
from .request import Request, State

__all__ = [
    "ChainEngine", "MockEngine", "PagedChainEngine", "PAGE_SIZE",
    "PageAccounting", "mock_orchestrator",
    "PagedCache", "SlotCache", "service_spec_for", "Orchestrator",
    "OrchestratorConfig", "PipelineChainEngine", "Request", "StageSpec",
    "State", "plan_stages",
]
