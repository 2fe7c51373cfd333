"""Host-side step planning for the fused engine pipeline (plan → execute
→ commit). The whole of ``repro.launch.stepplan``, ported as is: it is
pure host arithmetic, so the port's plans equal the JAX package's.

One engine step executes exactly the work a :class:`StepPlan` selects
under a single decode-priority TOKEN budget (``Engine(step_tokens=...)``,
replacing ``max_prefill_tokens_per_step`` as the only pacing knob on the
fused path):

1. every decoding slot is charged 1 token FIRST — decode rows are never
   displaced by prefill work (the starvation guarantee the budget tests
   assert);
2. the remaining budget goes to chunk-prefill rows, oldest admission
   first, each granted a page-aligned span via :func:`chunk_span`;
3. whatever is left paces ADMISSION (`Scheduler.admit(budget=...)`).

A selected chunk row with budget remaining always makes progress — at
least one page, or the final partial tail — so a budget smaller than one
page cannot livelock a mid-prompt slot (min-progress rule). All of this
is pure host arithmetic over ints: no tensors, no device syncs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.models.paging import pow2_ceil


@dataclass(frozen=True)
class ChunkRow:
    """One prefill-chunk row of a fused step: prompt tokens
    [start, end) of ``slot``'s request, executed at absolute positions
    start..end-1. ``final`` marks the chunk that completes the prompt
    (its last-token logits seed decoding)."""
    slot: int
    start: int
    end: int
    final: bool

    @property
    def length(self) -> int:
        return self.end - self.start


@dataclass
class StepPlan:
    """The work ONE engine step will execute in a single fused dispatch.

    ``decode_slots`` decode one token each; ``chunk_rows`` prefill their
    page-aligned spans; ``budget`` echoes the step's token budget (None =
    unbounded). Slots with no work this step ride the fused batch as
    inactive rows (row_len 0)."""
    budget: Optional[int] = None
    decode_slots: List[int] = field(default_factory=list)
    chunk_rows: List[ChunkRow] = field(default_factory=list)

    @property
    def tokens_planned(self) -> int:
        return len(self.decode_slots) + sum(c.length for c in self.chunk_rows)

    @property
    def width(self) -> int:
        """Row width W of the fused batch: the longest span, bucketed to a
        power of two so one jit serves every chunk size in the bucket
        (decode-only steps compile the W=1 variant)."""
        w = 1
        for c in self.chunk_rows:
            w = max(w, c.length)
        return pow2_ceil(w)

    @property
    def utilization(self) -> float:
        """tokens_planned / budget — the per-step budget-pressure signal
        (obs gauge ``nbl_step_budget_utilization``). 0.0 when unbounded:
        with no budget there is no pressure to report."""
        if not self.budget:
            return 0.0
        return self.tokens_planned / self.budget

    def has_work(self) -> bool:
        return bool(self.decode_slots or self.chunk_rows)


def decode_first_budget(budget: Optional[int], n_decode: int) -> Optional[int]:
    """Token budget left for chunk rows after every decode row is charged
    first. Decode rows themselves are NEVER trimmed: with budget <=
    n_decode the step still decodes every slot and chunks get nothing."""
    if budget is None:
        return None
    return max(0, budget - n_decode)


def chunk_span(filled: int, plen: int, chunk_tokens: int,
               remaining: Optional[int], page_size: int) -> int:
    """End (exclusive) of the page-aligned span one chunk row may prefill
    this step: resume at ``filled`` (a page multiple), bounded by the
    per-row cap ``chunk_tokens``, the prompt length ``plen``, and the
    step's ``remaining`` token budget (None = unbounded).

    Returns ``filled`` itself (an empty span — the row waits) only when
    the remaining budget is exhausted; any positive remainder grants at
    least one page or the final partial tail (min-progress), so sub-page
    budgets still drain the prompt one page per step."""
    left = plen - filled
    span = min(chunk_tokens, left)
    if remaining is not None:
        if remaining <= 0:
            return filled
        if remaining < span:
            span = (remaining // page_size) * page_size
            if span == 0:
                span = min(page_size, left)
    return filled + span
