"""Serving layer: live orchestrator, chain engines and KV caches."""
from .engine import ChainEngine, PagedChainEngine
from .kv_cache import (
    PAGE_SIZE,
    PageAccounting,
    PagedCache,
    SlotCache,
    service_spec_for,
)
from .orchestrator import Orchestrator, OrchestratorConfig
from .request import Request, State

__all__ = [
    "ChainEngine", "PagedChainEngine", "PAGE_SIZE", "PageAccounting",
    "PagedCache", "SlotCache", "service_spec_for", "Orchestrator",
    "OrchestratorConfig", "Request", "State",
]
