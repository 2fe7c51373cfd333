"""Seeded serving replay of the port's Engine, after tests/test_serving_fuzz.py,
in its two admissions: chunked prefill, and whole-prompt admission prefill
(bucketed, and exact with ``bucket_prompts=False``).

Each workload is drawn from a seeded numpy RNG: the config (tiny-dense,
tiny-swa, tiny-gemma, NBL-2 tiny-dense), ragged prompts, per-request
``max_new``, an optional EOS, a mid-stream submission schedule, the slot
count, a page pool shrunk below full reservation (so requests are
preempted), the chunk size and a ``step_tokens`` budget. After every step
the allocator's invariants hold and every slot's page-table row is covered
by its references; at the end every page is free and each request's
tokens equal the port's own ``generate`` (truncated at the first EOS, as
the engine retires). Port only, on the CPU: the lockstep against the JAX
engine is tests/test_torch_engine.py."""
from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.surgery import nbl_variant  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.paging import (  # noqa: E402
    n_caching_attn_layers, page_bytes, pages_per_seq,
)
from repro_torch.models.transformer import init_params  # noqa: E402

MAX_LEN, PAGE_SIZE = 32, 4
ARCHS = (("tiny-dense", 0), ("tiny-swa", 0), ("tiny-gemma", 0),
         ("tiny-dense", 2))
MODES = {
    "chunked": dict(chunked_prefill=True),
    "whole": dict(chunked_prefill=False),
    "whole_exact": dict(chunked_prefill=False, bucket_prompts=False),
}
SEEDS = range(4)


@functools.lru_cache(maxsize=None)
def _model(arch, m):
    cfg = nbl_variant(get_config(arch), m)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _draw_workload(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    arch, m = ARCHS[rng.integers(0, len(ARCHS))]
    cfg, _ = _model(arch, m)
    reqs = []
    for _ in range(int(rng.integers(2, 8))):
        max_new = int(rng.integers(1, 13))
        plen = int(rng.integers(1, MAX_LEN - max_new + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        delay = int(rng.integers(0, 6)) if rng.random() < 0.4 else 0
        reqs.append((prompt, max_new, delay))
    pps = pages_per_seq(MAX_LEN, PAGE_SIZE)
    n_slots = int(rng.integers(2, 5))
    return dict(
        arch=arch, m=m, reqs=reqs, n_slots=n_slots,
        eos_id=(int(rng.integers(0, cfg.vocab_size))
                if rng.random() < 0.3 else None),
        n_pages=int(rng.integers(pps, (n_slots + 1) * pps // 2 + 1)),
        chunk_tokens=int(rng.choice([PAGE_SIZE, 3 * PAGE_SIZE, 2 * MAX_LEN])),
        step_tokens=(None if (r := rng.random()) < 0.5
                     else int(rng.integers(1, PAGE_SIZE)) if r < 0.7
                     else int(rng.integers(PAGE_SIZE, 4 * PAGE_SIZE + 1))))


def _check_invariants(eng: Engine) -> None:
    eng.allocator.check_invariants()
    for slot in range(eng.n_slots):
        row = set(int(p) for p in eng.page_tbl[slot] if p >= 0)
        held = set(eng.slot_pages[slot])
        assert row <= held, (slot, row, held)
        for pid in held:
            assert eng.allocator.refcount(pid) >= 1, (slot, pid)
        if eng.slot_req[slot] is None:
            assert not held and not row, (slot, held, row)


def _oracle(cfg, params, prompt, max_new, eos_id):
    out = generate(cfg, params, prompt[None], max_new=max_new).numpy()[0]
    if eos_id is not None:
        hits = np.nonzero(out == eos_id)[0]
        if hits.size:
            out = out[:hits[0] + 1]
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", list(MODES))
def test_serving_replay_matches_generate(mode, seed):
    w = _draw_workload(seed)
    cfg, params = _model(w["arch"], w["m"])
    kw = dict(MODES[mode])
    if kw["chunked_prefill"]:
        kw["prefill_chunk_tokens"] = w["chunk_tokens"]
    budget = w["n_pages"] * n_caching_attn_layers(cfg) \
        * page_bytes(cfg, PAGE_SIZE)
    eng = Engine(cfg, params, max_len=MAX_LEN, n_slots=w["n_slots"],
                 cache_budget_bytes=budget, expected_len=PAGE_SIZE,
                 page_size=PAGE_SIZE, eos_id=w["eos_id"],
                 step_tokens=w["step_tokens"], device="cpu", **kw)
    assert (eng.n_pages, eng.n_slots) == (w["n_pages"], w["n_slots"])
    pending = sorted(enumerate(w["reqs"]), key=lambda r: r[1][2])
    rids: dict[int, int] = {}
    t = emitted = 0
    while pending or eng.has_work:
        while pending and pending[0][1][2] <= t:
            i, (prompt, max_new, _) = pending.pop(0)
            rids[i] = eng.submit(prompt, max_new)
        emitted += eng.step()
        _check_invariants(eng)
        t += 1
        assert t < 600, "workload failed to drain"
    assert eng.allocator.in_use == 0
    kept = sum(len(r.tokens) for r in eng.finished.values())
    assert emitted >= kept                  # preempted work was re-emitted
    for i, (prompt, max_new, _) in enumerate(w["reqs"]):
        want = _oracle(cfg, params, prompt, max_new, w["eos_id"])
        got = np.asarray(eng.finished[rids[i]].tokens, np.int32)
        np.testing.assert_array_equal(
            got, want, err_msg=f"mode={mode} seed={seed} req={i} "
                               f"(arch={w['arch']}, m={w['m']})")
