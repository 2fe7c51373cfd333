"""Request scheduling for the paged serving engine.

Port of ``Request``, ``Scheduler`` and ``nbl_page_budget`` from
``repro.launch.scheduler``. ``Scheduler`` holds the FIFO queue of waiting
requests and decides how many may be admitted this step;
``launch/engine.py`` owns the page pools and moves admitted requests
through chunked prefill -> decode -> retirement.

Page budget: the pool is sized in pages and a request is billed only the
pages an expected generation length references:

    pool_pages  = budget_bytes // (caching_layers * page_bytes)
    per_request = ceil(expected_len / page_size)
    n_requests  = clamp(pool_pages // per_request, 1, max_slots)

NBL-linearized layers carry NO page pool, so compressing m of K attention
layers shrinks the per-request bill by m/K (paper §4.2) and the admitted
count rises with m at a fixed budget.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.paging import pages_per_seq, pool_pages_for_budget


@dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int32 token array."""
    rid: int
    prompt: np.ndarray
    max_new: int
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0
    tokens: list = field(default_factory=list)
    n_preemptions: int = 0
    error: Optional[str] = None
    # admission ORDER, monotone per admission incl. re-admission after
    # preemption: the engine's age comparisons key on this, not t_admit
    admit_seq: int = 0


def nbl_page_budget(cfg: ModelConfig, budget_bytes: int, *, page_size: int,
                    expected_len: int, max_slots: int = 256) -> int:
    """Concurrent-request count a byte budget buys under PAGED allocation
    (stacks with no caching attention layer clamp to ``max_slots``). The
    JAX version's ``shared_prefix_len`` (prefix sharing) comes with that
    mode."""
    pool = pool_pages_for_budget(cfg, budget_bytes, page_size)
    if pool is None:
        return max_slots
    per_req = pages_per_seq(max(1, expected_len), page_size)
    return int(max(1, min(max_slots, pool // per_req)))


class Scheduler:
    """FIFO admission queue with per-step caps: at most
    ``max_prefill_per_step`` requests and (optionally) at most
    ``max_prefill_tokens_per_step`` prompt tokens per step. The queue's
    HEAD request always admits, so an over-budget prompt cannot starve the
    queue."""

    def __init__(self, *, max_prefill_per_step: int = 4,
                 max_prefill_tokens_per_step: Optional[int] = None):
        if max_prefill_per_step < 1:
            raise ValueError("max_prefill_per_step must be >= 1")
        if max_prefill_tokens_per_step is not None \
                and max_prefill_tokens_per_step < 1:
            raise ValueError("max_prefill_tokens_per_step must be >= 1 or "
                             "None")
        self.queue: deque[Request] = deque()
        self.max_prefill_per_step = max_prefill_per_step
        self.max_prefill_tokens_per_step = max_prefill_tokens_per_step
        self._next_rid = 0

    def make_request(self, prompt, max_new: int) -> Request:
        """A Request with a fresh rid, neither queued nor validated."""
        rid = self._next_rid
        self._next_rid += 1
        return Request(rid=rid, prompt=np.asarray(prompt, np.int32).reshape(-1),
                       max_new=max_new, t_submit=time.monotonic())

    def submit_request(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self, free_slots: int,
              budget: Optional[int] = None) -> list[Request]:
        """Pop FIFO requests for this step: at most min(free_slots,
        max_prefill_per_step), stopping before a prompt that would push
        the step past the narrower of ``max_prefill_tokens_per_step`` and
        the caller's ``budget``. The head request always admits."""
        n = min(free_slots, self.max_prefill_per_step, len(self.queue))
        if budget is not None:
            budget = budget if self.max_prefill_tokens_per_step is None \
                else min(budget, self.max_prefill_tokens_per_step)
        else:
            budget = self.max_prefill_tokens_per_step
        out: list[Request] = []
        toks = 0
        while len(out) < n:
            nxt = self.queue[0]
            if out and budget is not None \
                    and toks + len(nxt.prompt) > budget:
                break
            toks += len(nxt.prompt)
            out.append(self.queue.popleft())
        return out

    def requeue(self, req: Request) -> None:
        """Return a request to the FRONT of the queue (admission deferred,
        or preempted: it restarts from its prompt)."""
        self.queue.appendleft(req)

    def __len__(self) -> int:
        return len(self.queue)
