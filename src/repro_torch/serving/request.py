"""Request lifecycle for the serving orchestrator."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class State(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    DEFERRED = "deferred"    # parked by the admission gate; readmitted later


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    eos_token: Optional[int] = None
    cls: int = 0                        # index into the orchestrator's
    #                                     RequestClass list (SLO class)
    # runtime state
    state: State = State.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    chain_idx: Optional[int] = None
    slot: Optional[int] = None
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    retries: int = 0

    @property
    def context_tokens(self) -> np.ndarray:
        """Prompt plus generated-so-far (used to re-prefill after failover)."""
        if not self.output:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.output, np.int32)])

    @property
    def done(self) -> bool:
        if len(self.output) >= self.max_new_tokens:
            return True
        return bool(self.output) and self.eos_token is not None \
            and self.output[-1] == self.eos_token

    def response_time(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def waiting_time(self) -> Optional[float]:
        if self.start_time is None:
            return None
        return self.start_time - self.arrival_time
