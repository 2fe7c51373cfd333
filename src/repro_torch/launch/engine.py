"""Continuous-batching serving engine over the PAGED KV cache, with the fused
plan -> execute -> commit step.

Port of the paged, fused path of ``repro.launch.engine.Engine``:

  plan     (host)  admit queued requests into free slots under the step's
                   decode-priority token budget (a non-chunked admission
                   runs its prompt's prefill here), grant page-aligned
                   prompt chunks oldest-first, fault the page each decoding
                   slot writes next (preempting the youngest request on a
                   dry pool);
  execute  (card)  ONE ``transformer.fused_step`` call over an
                   ``(n_slots, W)`` batch of decode rows (1 token), chunk
                   rows (their span) and inactive rows (0 tokens), W a
                   power of two;
  commit   (host)  ONE logits readback (``.cpu()``), greedy emission,
                   chunk progress, retirement.

Two admissions, as in the JAX engine:

  chunked_prefill=True   admitted -> chunking(pos) -> decoding -> retired.
                         Admission runs no prefill: the prompt is served by
                         chunk rows of the fused step, and its final
                         chunk's last-token logits seed decoding.
  chunked_prefill=False  admitted -> decoding -> retired. Admission
                         allocates the prompt's pages and runs ONE prefill
                         of the whole prompt at batch 1 (right-padded to a
                         power-of-two bucket; attention through K3),
                         writes its position-aligned cache into the pages
                         (``paging.assign_pages``) and emits the first
                         token from its last-token logits.

Modes of the JAX engine that belong to later slices of the port raise
``NotImplementedError`` naming the slice: the ring layout, the legacy
two-dispatch step (``fused_step=False``), ``prefix_sharing``, speculative
``drafts`` and ``obs``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.scheduler import Request, Scheduler, nbl_page_budget
from repro_torch.launch.stepplan import (
    ChunkRow, StepPlan, chunk_span, decode_first_budget,
)
from repro_torch.models.paging import (
    DEFAULT_PAGE_SIZE, PageAllocator, assign_pages, build_page_table,
    init_paged_cache, n_caching_attn_layers, pages_per_seq,
    pool_pages_for_budget, pow2_ceil, span_pages,
)
from repro_torch.models.transformer import fused_step, prefill

_LATER = {
    "paged": "the ring slot layout (ROADMAP.md §A7)",
    "fused_step": "the legacy two-dispatch step (ROADMAP.md §A7)",
    "prefix_sharing": "prefix sharing (ROADMAP.md §A)",
    "drafts": "speculative decoding (ROADMAP.md §A7)",
    "obs": "the obs hooks (ROADMAP.md §A7)",
}


def _later(what: str):
    return NotImplementedError(f"{what}: not in this slice of the port; "
                               f"it comes with {_LATER[what]}")


class Engine:
    """Request-level continuous-batching engine over page pools.

    Either ``n_slots`` or ``cache_budget_bytes`` (converted through
    ``nbl_page_budget``) fixes the concurrency; given both, the budget is a
    ceiling. ``max_len`` bounds prompt + generated tokens per request.
    ``page_size`` must be a power of two. With ``chunked_prefill`` (the
    default), prompts are split into page-aligned chunks of
    ``prefill_chunk_tokens`` (rounded up to a page multiple; default one
    page); without it, admission prefills the whole prompt, right-padded
    to a power-of-two bucket when ``bucket_prompts`` (the JAX default) or
    exact otherwise. ``step_tokens`` (default None = unbounded)
    is the per-step decode-priority token budget: decode rows are charged
    first, the remainder grants chunk spans and paces admission.

    ``device`` (default ``"cuda"``) holds the page pools and must hold the
    params; ``"cuda"`` with no CUDA device raises. ``paged`` defaults to
    True, the only layout this slice of the port serves.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_len: int,
                 n_slots: Optional[int] = None,
                 cache_budget_bytes: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 paged: bool = True,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 expected_len: Optional[int] = None,
                 bucket_prompts: bool = True,
                 prefix_sharing: bool = False,
                 chunked_prefill: bool = True,
                 prefill_chunk_tokens: Optional[int] = None,
                 fused_step: bool = True,
                 step_tokens: Optional[int] = None,
                 obs=None, drafts: Optional[dict] = None,
                 device="cuda"):
        for name, val in (("paged", not paged),
                          ("fused_step", not fused_step),
                          ("prefix_sharing", prefix_sharing),
                          ("drafts", drafts), ("obs", obs is not None)):
            if val:
                raise _later(name)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}: move them with "
                             "models.transformer.params_to")
        self.page_size = int(page_size)
        if self.page_size < 1 or self.page_size & (self.page_size - 1):
            raise ValueError(f"page_size must be a power of two, "
                             f"got {page_size}")
        self.chunked = bool(chunked_prefill)
        self.chunk_tokens = 0
        if self.chunked:
            ct = self.page_size if prefill_chunk_tokens is None \
                else int(prefill_chunk_tokens)
            if ct < 1:
                raise ValueError(f"prefill_chunk_tokens must be >= 1, "
                                 f"got {prefill_chunk_tokens}")
            # chunks END on page boundaries so the next chunk resumes on one
            self.chunk_tokens = -(-ct // self.page_size) * self.page_size
        self.bucket_prompts = bool(bucket_prompts)
        expected_len = int(expected_len or max_len)

        n_pages = None
        if cache_budget_bytes is not None:
            n_pages = pool_pages_for_budget(cfg, cache_budget_bytes,
                                            self.page_size)
            budget_slots = nbl_page_budget(cfg, cache_budget_bytes,
                                           page_size=self.page_size,
                                           expected_len=expected_len)
            n_slots = budget_slots if n_slots is None \
                else min(n_slots, budget_slots)
        elif n_slots is None:
            raise ValueError("need n_slots or cache_budget_bytes")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if step_tokens is not None and int(step_tokens) < 1:
            raise ValueError(f"step_tokens must be >= 1, got {step_tokens}")
        self.step_tokens = int(step_tokens) if step_tokens is not None \
            else None
        self.cfg = cfg
        self.params = params
        self.max_len = int(max_len)
        self.n_slots = int(n_slots)
        self.eos_id = eos_id
        self.scheduler = Scheduler()

        blocks = cfg.blocks()
        # pure sliding-window stacks release pages that fall below EVERY
        # layer's window; one global layer pins everything
        windows = [b.window for b in blocks if b.kind == "attn"]
        self._page_window = (max(windows) if windows
                             and all(w is not None for w in windows)
                             else None)
        self._pps = pages_per_seq(self.max_len, self.page_size)
        if n_pages is None:
            n_pages = self.n_slots * self._pps       # full-reservation pool
        if n_caching_attn_layers(cfg) > 0:
            # a lone request must always be able to run to max_len
            n_pages = max(int(n_pages), self._pps)
        self.n_pages = int(n_pages)
        self.allocator = PageAllocator(self.n_pages)
        self.page_tbl = build_page_table(self.n_slots, self.max_len,
                                         self.page_size)
        self.slot_pages: list[list[int]] = [[] for _ in range(self.n_slots)]
        self.cache = init_paged_cache(cfg, self.n_slots, self.max_len,
                                      page_size=self.page_size,
                                      n_pages=self.n_pages,
                                      device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * self.n_slots
        self.slot_pos = np.zeros(self.n_slots, np.int32)   # pos of last tok
        self.slot_tok = np.zeros(self.n_slots, np.int32)   # last emitted tok
        # chunk progress: -1 = not chunking (free or decoding); >= 0 =
        # prompt tokens already cached (a page multiple mid-prompt)
        self.slot_chunk_pos = np.full(self.n_slots, -1, np.int32)
        self.finished: dict[int, Request] = {}
        self.n_finished = 0
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_chunks = 0
        self.n_interleaved_decode_steps = 0
        self.n_prefill_tokens = 0
        self.n_preemptions = 0
        self.n_rejected = 0
        self._admit_seq = 0
        # ONE per fused_step call: the per-step dispatch contract
        self.n_fused_dispatches = 0
        self._budget_util_sum = 0.0
        self._n_planned_steps = 0
        self._pool_in_use_sum = 0

    # ------------------------------------------------------------- admin --

    def submit(self, prompt, max_new: int, *, strict: bool = False) -> int:
        """Queue a request; returns its id. An unservable submission (empty
        prompt, ``max_new < 1``, prompt + max_new > max_len) is recorded as
        rejected (``Request.error``, ``n_rejected``) and its rid returned;
        ``strict=True`` raises instead."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            err = "empty prompt"
        elif max_new < 1:
            err = f"max_new must be >= 1, got {max_new}"
        elif prompt.size + max_new > self.max_len:
            err = (f"prompt({prompt.size}) + max_new({max_new}) exceeds "
                   f"engine max_len={self.max_len}")
        else:
            req = self.scheduler.make_request(prompt, max_new)
            self.scheduler.submit_request(req)
            return req.rid
        if strict:
            raise ValueError(err)
        return self._submit_rejected(prompt, max_new, err)

    def _submit_rejected(self, prompt, max_new: int, reason: str) -> int:
        req = self.scheduler.make_request(prompt, max_new)
        self._reject(req, reason)
        return req.rid

    def _reject(self, req: Request, reason: str) -> None:
        req.error = reason
        req.t_finish = time.monotonic()
        self.finished[req.rid] = req
        self.n_rejected += 1

    @property
    def active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.active_slots) or len(self.scheduler) > 0

    # ----------------------------------------------------------- serving --

    def _sample(self, logits_row: np.ndarray) -> int:
        """Greedy: logits_row (V,) float32."""
        return int(np.argmax(logits_row))

    def _emit(self, req: Request, slot: int, tok: int, now: float) -> None:
        """Record one generated token; retire the slot when done."""
        req.tokens.append(tok)
        if not req.t_first:
            req.t_first = now
        self.slot_tok[slot] = tok
        done = (len(req.tokens) >= req.max_new
                or (self.eos_id is not None and tok == self.eos_id))
        if done:
            # freed pages are position-masked until the next owner
            # overwrites them: no scrub
            req.t_finish = now
            self.finished[req.rid] = req
            self.n_finished += 1
            self.slot_req[slot] = None
            self._release_pages(slot)

    def _release_pages(self, slot: int) -> None:
        if self.slot_pages[slot]:
            self.allocator.unref(self.slot_pages[slot])
            self.slot_pages[slot] = []
        self.page_tbl[slot, :] = -1

    def _preempt(self, slot: int) -> None:
        """Evict the request in ``slot``: unref its pages and send it back
        to the queue front. It restarts from its prompt."""
        req = self.slot_req[slot]
        assert req is not None
        self._release_pages(slot)
        self.slot_req[slot] = None
        self.slot_chunk_pos[slot] = -1
        req.tokens = []
        req.t_first = 0.0
        req.t_admit = 0.0
        req.n_preemptions += 1
        self.scheduler.requeue(req)
        self.n_preemptions += 1

    def _youngest_active(self) -> int:
        return max(self.active_slots,
                   key=lambda s: self.slot_req[s].admit_seq)

    def _release_window_pages(self, slot: int, pos: int) -> None:
        """Free this slot's pages that sit entirely below the attention
        horizon (positions < pos - window + 1): the mask can never read
        them again."""
        horizon = pos - self._page_window + 1
        n_dead = max(0, min(horizon // self.page_size, self._pps))
        dead = [int(p) for p in self.page_tbl[slot, :n_dead] if p >= 0]
        if dead:
            self.allocator.unref(dead)
            self.page_tbl[slot, :n_dead] = -1
            gone = set(dead)
            self.slot_pages[slot] = [p for p in self.slot_pages[slot]
                                     if p not in gone]

    def _ensure_decode_pages(self) -> None:
        """Allocate the page each decoding slot's next write lands in; on a
        dry pool, preempt the youngest request until the fault is served."""
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None or self.slot_chunk_pos[slot] >= 0:
                continue       # free, or mid-prompt (chunk rows own those)
            if self._page_window is not None:
                self._release_window_pages(slot, int(self.slot_pos[slot]))
            lp = int(self.slot_pos[slot]) // self.page_size
            if self.page_tbl[slot, lp] >= 0:
                continue
            while self.slot_req[slot] is not None:
                ids = self.allocator.alloc(1)
                if ids is not None:
                    self.page_tbl[slot, lp] = ids[0]
                    self.slot_pages[slot].append(ids[0])
                    break
                self._preempt(self._youngest_active())

    def _fault_pages(self, req: Request) -> int:
        """Pages this request can fault in ONE step once decoding: the next
        boundary crossing. (The JAX version adds a speculative request's
        candidate span, which comes with drafts.)"""
        return 1

    def _fault_reserve(self) -> int:
        """Headroom pages for everything in flight: the per-request fault
        bound summed."""
        return sum(self._fault_pages(self.slot_req[s])
                   for s in self.active_slots)

    def _can_admit(self, req: Request) -> bool:
        """Page-gated admission. Chunked: the FIRST chunk's pages must be
        free, plus the fault reserve of everything in flight. Whole-prompt:
        all the prompt's pages, plus the reserve, plus the request's own
        fault when the prompt ends on a page boundary (its first decode
        write opens a fresh page)."""
        plen = len(req.prompt)
        if self.chunked:
            first_end = min(self.chunk_tokens, plen)
            need = (pages_per_seq(first_end, self.page_size)
                    + self._fault_reserve())
            return self.allocator.free_pages >= need
        own_fault = self._fault_pages(req) \
            if plen % self.page_size == 0 else self._fault_pages(req) - 1
        need = (pages_per_seq(plen, self.page_size) + own_fault
                + self._fault_reserve())
        return self.allocator.free_pages >= need

    def _admit(self, req: Request, slot: int) -> None:
        """Chunked: admitted -> chunking(0), no prefill here (the fused
        step's chunk rows prefill the prompt). Whole-prompt: allocate the
        prompt's pages, prefill it, emit the first token -> decoding."""
        req.t_admit = time.monotonic()
        self._admit_seq += 1
        req.admit_seq = self._admit_seq
        if self.chunked:
            self.slot_req[slot] = req
            self.slot_chunk_pos[slot] = 0
            return
        plen = len(req.prompt)
        ids = self.allocator.alloc(pages_per_seq(plen, self.page_size))
        assert ids is not None, "admission checked page availability"
        self.page_tbl[slot, :len(ids)] = ids
        self.slot_pages[slot].extend(ids)
        logits = self._run_partial_prefill(slot, req, 0, plen)
        self.slot_req[slot] = req
        self.slot_pos[slot] = plen               # position of its 1st token
        # the admission's one readback: its last-token logits row
        tok = self._sample(logits[0, -1].float().cpu().numpy())
        self._emit(req, slot, tok, time.monotonic())

    def _prefill_plan(self, prompt_len: int) -> tuple[int, int, bool]:
        """(token_len, cache_len, masked) for a prompt span. Bucketing pads
        the TOKENS to a power of two (at least a page, at most the page
        table) and masks with valid_len; without it the tokens stay exact
        and only the cache rounds up to a page multiple."""
        if self.bucket_prompts:
            b = pow2_ceil(prompt_len)
            b = min(max(b, self.page_size), self._pps * self.page_size)
            return b, b, True
        cl = pages_per_seq(prompt_len, self.page_size) * self.page_size
        return prompt_len, cl, False

    def _run_partial_prefill(self, slot: int, req: Request, start: int,
                             end: int) -> torch.Tensor:
        """Prefill prompt[start:end) of ``slot``'s request into the page
        pools (``start`` page-aligned; the span's pages already in the
        table): pad or bucket the span, hand the slot's own pages
        [0, start / page_size) to ``prefill`` as the prefix, and write the
        returned cache into the span's pages. Returns the span's last-token
        logits (1, 1, V). (The JAX version also publishes the span's full
        pages to the prefix index; that comes with prefix sharing.)"""
        ps, dev = self.page_size, self.device
        span = req.prompt[start:end]
        token_len, cache_len, masked = self._prefill_plan(len(span))
        tokens = np.zeros(token_len, np.int32)
        tokens[:len(span)] = span
        start_pg = start // ps
        pb = pow2_ceil(start_pg) if start_pg else 0
        kw = {}
        if pb:
            ptbl = np.full(pb, -1, np.int32)
            ptbl[:start_pg] = self.page_tbl[slot, :start_pg]
            kw = dict(prefix_cache=self.cache,
                      prefix_tbl=torch.from_numpy(ptbl).to(dev),
                      prefix_len=start)
        logits, pcache = prefill(
            self.cfg, self.params, torch.from_numpy(tokens).to(dev)[None],
            cache_len=cache_len, paged=True,
            valid_len=len(span) if masked else None, **kw)
        self.n_prefills += 1
        self.n_prefill_tokens += len(span)
        # span tiles map to logical pages [start_pg, ...)
        row = np.full(self._pps, -1, np.int32)
        row[:self._pps - start_pg] = self.page_tbl[slot, start_pg:]
        assign_pages(self.cfg, self.cache, pcache,
                     torch.from_numpy(row).to(dev), page_size=ps)
        return logits

    def step(self) -> int:
        """One engine iteration (plan -> execute -> commit). Returns the
        number of tokens emitted."""
        emitted = self._plan_admission()
        return emitted + self._step_fused()

    def _plan_admission(self) -> int:
        """PLAN, phase 1: pop queued requests into free slots (FIFO,
        page-gated), paced by what the token budget leaves after charging
        every decoding slot 1 token. The queue head always admits. Returns
        the tokens emitted (one per whole-prompt admission)."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        emitted = 0
        budget = None
        if self.step_tokens is not None:
            n_dec = sum(1 for s in self.active_slots
                        if self.slot_chunk_pos[s] < 0)
            budget = decode_first_budget(self.step_tokens, n_dec)
        pending = self.scheduler.admit(len(free), budget=budget)
        while pending:
            req = pending.pop(0)
            if len(req.prompt) + req.max_new > self.max_len:
                # direct scheduler submissions bypass submit()'s check
                self._reject(req, f"prompt({len(req.prompt)}) + max_new"
                             f"({req.max_new}) exceeds max_len"
                             f"={self.max_len}")
                continue
            if not self._can_admit(req):
                for r in reversed([req] + pending):   # restore FIFO order
                    self.scheduler.requeue(r)
                break
            self._admit(req, free.pop())
            if not self.chunked:
                emitted += 1                   # prefill emits a first token
        return emitted

    def _plan_chunks(self, plan: StepPlan) -> dict[int, Request]:
        """PLAN, phase 2: grant page-aligned prompt spans to chunking slots,
        OLDEST admission first, under the budget left after every decoding
        slot's 1-token charge. A row whose pages cannot be found preempts
        strictly-younger slots, else stops the granting (the oldest
        suspended row is never jumped). Returns {slot: request} at grant
        time."""
        row_req: dict[int, Request] = {}
        n_dec = sum(1 for s in self.active_slots
                    if self.slot_chunk_pos[s] < 0)
        remaining = decode_first_budget(self.step_tokens, n_dec)
        chunking = sorted(
            (s for s in self.active_slots if self.slot_chunk_pos[s] >= 0),
            key=lambda s: self.slot_req[s].admit_seq)
        ps = self.page_size
        for slot in chunking:
            req = self.slot_req[slot]
            if req is None or self.slot_chunk_pos[slot] < 0:
                continue   # preempted while an older row evicted youngers
            filled = int(self.slot_chunk_pos[slot])
            plen = len(req.prompt)
            end = chunk_span(filled, plen, self.chunk_tokens, remaining, ps)
            if end <= filled:
                break      # budget exhausted: younger rows wait too
            start_pg, end_pg = span_pages(filled, end, ps)
            need = end_pg - start_pg
            granted = True
            while True:
                ids = self.allocator.alloc(need)
                if ids is not None:
                    break
                younger = [s for s in self.active_slots
                           if self.slot_req[s].admit_seq > req.admit_seq]
                if not younger:
                    granted = False
                    break
                self._preempt(max(younger,
                                  key=lambda s: self.slot_req[s].admit_seq))
            if not granted:
                break      # pool dry for the oldest row: stop granting
            self.page_tbl[slot, start_pg:end_pg] = ids
            self.slot_pages[slot].extend(ids)
            plan.chunk_rows.append(ChunkRow(slot, filled, end,
                                            final=end >= plen))
            row_req[slot] = req
            if remaining is not None:
                remaining -= end - filled
        return row_req

    def _step_fused(self) -> int:
        """Plan chunk rows, fault decode pages, then EXECUTE one fused step
        and COMMIT."""
        plan = StepPlan(budget=self.step_tokens)
        row_req = self._plan_chunks(plan)
        self._ensure_decode_pages()
        # paging faults above may have preempted slots the plan selected
        plan.decode_slots = [s for s in self.active_slots
                             if self.slot_chunk_pos[s] < 0]
        plan.chunk_rows = [c for c in plan.chunk_rows
                           if self.slot_req[c.slot] is row_req[c.slot]]
        if not plan.has_work():
            return 0
        self._budget_util_sum += plan.utilization
        self._n_planned_steps += 1
        logits = self._execute_fused(plan)
        return self._commit_fused(plan, logits)

    def _fused_inputs(self, plan: StepPlan):
        """The step's (n_slots, W) mixed batch as host arrays (tokens,
        row_pos, row_len). Free slots and suspended chunkers ride with
        row_len 0: their K/V writes are filtered out and they attend
        nothing, so the live page table is shared as is."""
        w = plan.width
        tokens = np.zeros((self.n_slots, w), np.int32)
        row_pos = np.zeros(self.n_slots, np.int32)
        row_len = np.zeros(self.n_slots, np.int32)
        for s in plan.decode_slots:
            tokens[s, 0] = self.slot_tok[s]
            row_pos[s] = self.slot_pos[s]
            row_len[s] = 1
        for c in plan.chunk_rows:
            tokens[c.slot, :c.length] = \
                self.slot_req[c.slot].prompt[c.start:c.end]
            row_pos[c.slot] = c.start
            row_len[c.slot] = c.length
        return tokens, row_pos, row_len

    def _execute_fused(self, plan: StepPlan) -> torch.Tensor:
        """EXECUTE: the step's ONE ``fused_step`` call."""
        tokens, row_pos, row_len = self._fused_inputs(plan)
        dev = self.device
        logits, self.cache = fused_step(
            self.cfg, self.params, torch.from_numpy(tokens).to(dev),
            self.cache, torch.from_numpy(row_pos).to(dev),
            torch.from_numpy(row_len).to(dev),
            torch.from_numpy(self.page_tbl).to(dev))
        self.n_fused_dispatches += 1
        if plan.decode_slots:
            self.n_decode_steps += 1
            self._pool_in_use_sum += self.allocator.in_use
        return logits

    def _commit_fused(self, plan: StepPlan, logits: torch.Tensor) -> int:
        """COMMIT: the step's single logits readback, then chunk progress,
        final-chunk seed emission, decode emission and retirement."""
        rows = logits[:, -1].float().cpu().numpy()     # THE readback
        emitted = 0
        now = time.monotonic()
        for c in plan.chunk_rows:
            req = self.slot_req[c.slot]
            self.n_chunks += 1
            self.n_prefills += 1
            self.n_prefill_tokens += c.length
            if c.final:
                # chunking -> decoding: the last-token logits seed the
                # request's first generated token
                self.slot_chunk_pos[c.slot] = -1
                self.slot_pos[c.slot] = len(req.prompt)
                self._emit(req, c.slot, self._sample(rows[c.slot]), now)
                emitted += 1
            else:
                self.slot_chunk_pos[c.slot] = c.end
        if plan.decode_slots and np.any(self.slot_chunk_pos >= 0):
            self.n_interleaved_decode_steps += 1   # decode BETWEEN chunks
        for slot in plan.decode_slots:
            req = self.slot_req[slot]
            assert req is not None
            self.slot_pos[slot] += 1
            self._emit(req, slot, self._sample(rows[slot]), now)
            emitted += 1
        return emitted

    def run(self, max_steps: Optional[int] = None) -> dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens} of TERMINAL
        requests (a ``max_steps``-bounded run may stop with work in
        flight)."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {rid: np.asarray(r.tokens, np.int32)
                for rid, r in sorted(self.finished.items())}

    def stats(self) -> dict:
        """The engine's counters (the chunk counters only when chunked)."""
        s = dict(
            n=self.n_finished, n_slots=self.n_slots,
            n_decode_steps=self.n_decode_steps, n_prefills=self.n_prefills,
            n_prefill_tokens=self.n_prefill_tokens,
            n_rejected=self.n_rejected,
            n_fused_dispatches=self.n_fused_dispatches,
            step_tokens=self.step_tokens,
            step_budget_utilization=(self._budget_util_sum
                                     / max(1, self._n_planned_steps)),
            n_pages=self.n_pages, n_preemptions=self.n_preemptions,
            pages_in_use=self.allocator.in_use,
            peak_pages_in_use=self.allocator.peak_in_use,
            pool_utilization=(self._pool_in_use_sum
                              / max(1, self.n_decode_steps)
                              / max(1, self.n_pages)))
        if self.chunked:
            s.update(n_chunks=self.n_chunks,
                     prefill_chunk_tokens=self.chunk_tokens,
                     n_interleaved_decode_steps=
                     self.n_interleaved_decode_steps)
        return s
