"""PyTorch port vs JAX reference: the fused pipeline's step planning.

Mirrors the unit cases of tests/test_stepplan.py: StepPlan / chunk_span /
decode_first_budget arithmetic against the JAX functions, then the same
engine-level budget edges on the port's Engine (CPU), whose plans and
counters must equal what the JAX engine does and whose tokens must equal
the JAX ``generate`` reference. Same prompt lengths and widths as the JAX
tests, so the reference side compiles little."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import stepplan as js  # noqa: E402
from repro.launch.engine import Engine as JaxEngine  # noqa: E402
from repro.launch.serve import generate  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro_torch.interop import config_from_jax, from_jax_params  # noqa: E402
from repro_torch.launch import stepplan as ts  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402


def _setup(arch="tiny-dense", seed=0):
    jcfg = jax_config(arch)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    cfg = config_from_jax(jcfg)
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


def _ref(jcfg, jparams, prompt, max_new):
    out = generate(jcfg, jparams, jnp.asarray(prompt)[None], max_new=max_new)
    return np.asarray(out)[0]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _engine(cfg, params, **kw):
    return Engine(cfg, params, paged=True, chunked_prefill=True,
                  device="cpu", **kw)


# ------------------------------------------------ plan arithmetic ----------

def test_pow2_ceil():
    for n in (1, 2, 3, 4, 5, 8, 9, 513):
        assert ts.pow2_ceil(n) == js.pow2_ceil(n)


def test_stepplan_properties():
    for mod in (ts, js):
        rows = [mod.ChunkRow(0, 0, 4, False), mod.ChunkRow(1, 4, 10, True)]
        plan = mod.StepPlan(budget=16, decode_slots=[2, 3], chunk_rows=rows)
        assert (plan.tokens_planned, plan.width, plan.utilization,
                plan.has_work()) == (12, 8, 12 / 16, True)
        empty = mod.StepPlan(budget=None)
        assert (empty.has_work(), empty.width, empty.utilization) \
            == (False, 1, 0.0)
        assert mod.StepPlan(budget=None, decode_slots=[0]).utilization == 0.0


def test_decode_first_budget():
    for args in ((None, 7), (8, 3), (2, 2), (2, 5)):
        assert ts.decode_first_budget(*args) == js.decode_first_budget(*args)


@pytest.mark.parametrize("args", [
    (0, 16, 8, None, 4), (12, 14, 8, None, 4), (4, 16, 8, 0, 4),
    (4, 16, 8, -3, 4), (0, 8, 8, 8, 4), (0, 16, 8, 7, 4), (0, 16, 8, 3, 4),
    (0, 16, 8, 1, 4), (12, 14, 8, 1, 4),
])
def test_chunk_span_edges(args):
    assert ts.chunk_span(*args) == js.chunk_span(*args)


# ------------------------------------------------ engine: budget edges -----

def test_sub_page_budget_drains_one_page_per_step():
    jcfg, jparams, cfg, params = _setup()
    prompt = _prompts(cfg.vocab_size, [16], seed=7)[0]
    eng = _engine(cfg, params, max_len=24, n_slots=1, page_size=4,
                  prefill_chunk_tokens=8, step_tokens=3)
    rid = eng.submit(prompt, 2)
    out = eng.run(max_steps=50)
    np.testing.assert_array_equal(out[rid], _ref(jcfg, jparams, prompt, 2))
    assert eng.n_chunks == 4
    s = eng.stats()
    assert s["step_budget_utilization"] > 1.0 and s["step_tokens"] == 3
    eng.allocator.check_invariants()
    assert eng.allocator.in_use == 0


def test_chunk_exactly_exhausts_budget():
    jcfg, jparams, cfg, params = _setup()
    prompt = _prompts(cfg.vocab_size, [8], seed=8)[0]
    eng = _engine(cfg, params, max_len=16, n_slots=1, page_size=4,
                  prefill_chunk_tokens=8, step_tokens=8)
    rid = eng.submit(prompt, 3)
    eng.step()
    assert eng.n_chunks == 1 and eng.n_fused_dispatches == 1
    assert eng.stats()["step_budget_utilization"] == 1.0
    out = eng.run(max_steps=20)
    np.testing.assert_array_equal(out[rid], _ref(jcfg, jparams, prompt, 3))


def test_prefill_only_then_decode_only_steps():
    jcfg, jparams, cfg, params = _setup()
    prompt = _prompts(cfg.vocab_size, [16], seed=9)[0]
    eng = _engine(cfg, params, max_len=24, n_slots=2, page_size=4,
                  prefill_chunk_tokens=4)
    rid = eng.submit(prompt, 3)
    for _ in range(4):
        eng.step()
    assert eng.n_chunks == 4 and eng.n_decode_steps == 0
    out = eng.run(max_steps=20)
    np.testing.assert_array_equal(out[rid], _ref(jcfg, jparams, prompt, 3))
    assert eng.n_decode_steps == 2
    assert eng.n_fused_dispatches == 6
    assert eng.n_interleaved_decode_steps == 0
    assert eng.stats()["step_budget_utilization"] == 0.0


def test_decode_rows_never_displaced_by_chunks():
    jcfg, jparams, cfg, params = _setup()
    shorts = _prompts(cfg.vocab_size, [4, 4], seed=10)
    longp = _prompts(cfg.vocab_size, [16], seed=11)[0]
    eng = _engine(cfg, params, max_len=32, n_slots=3, page_size=4,
                  prefill_chunk_tokens=4, step_tokens=2)
    sids = [eng.submit(p, 8) for p in shorts]
    eng.step()
    eng.step()
    lid = eng.submit(longp, 4)
    starved, steps = 0, 0
    while eng.has_work and steps < 100:
        both = sum(1 for r in eng.slot_req
                   if r is not None and r.rid in sids) == 2
        lslot = next((i for i, r in enumerate(eng.slot_req)
                      if r is not None and r.rid == lid), None)
        lpos = None if lslot is None else int(eng.slot_chunk_pos[lslot])
        e = eng.step()
        steps += 1
        if both and lpos == 0:
            assert e == 2
            assert int(eng.slot_chunk_pos[lslot]) == 0
            starved += 1
    assert not eng.has_work and starved >= 4
    for sid, p in zip(sids, shorts):
        np.testing.assert_array_equal(eng.finished[sid].tokens,
                                      _ref(jcfg, jparams, p, 8))
    np.testing.assert_array_equal(eng.finished[lid].tokens,
                                  _ref(jcfg, jparams, longp, 4))
    eng.allocator.check_invariants()
    assert eng.allocator.in_use == 0


def test_budget_grants_oldest_chunker_first():
    jcfg, jparams, cfg, params = _setup()
    p1, p2 = _prompts(cfg.vocab_size, [16, 16], seed=12)
    eng = _engine(cfg, params, max_len=24, n_slots=2, page_size=4,
                  prefill_chunk_tokens=4, step_tokens=4)
    r1, r2 = eng.submit(p1, 2), eng.submit(p2, 2)
    for _ in range(4):
        eng.step()
    slot = {r.rid: i for i, r in enumerate(eng.slot_req) if r is not None}
    assert eng.slot_chunk_pos[slot[r1]] < 0
    assert eng.slot_chunk_pos[slot[r2]] == 0
    out = eng.run(max_steps=50)
    np.testing.assert_array_equal(out[r1], _ref(jcfg, jparams, p1, 2))
    np.testing.assert_array_equal(out[r2], _ref(jcfg, jparams, p2, 2))


def test_plans_equal_jax_engine_step_by_step():
    """A mixed decode + chunk workload: every step of the port plans the
    same rows (width, decode slots, chunk rows) as the JAX engine, with at
    most one fused_step call per step()."""
    jcfg, jparams, cfg, params = _setup()
    prompts = _prompts(cfg.vocab_size, [4, 5, 24], seed=3)
    kw = dict(max_len=40, n_slots=3, page_size=4, prefill_chunk_tokens=4,
              step_tokens=12)
    teng = _engine(cfg, params, **kw)
    jeng = JaxEngine(jcfg, jparams, paged=True, chunked_prefill=True, **kw)
    plans = {"t": [], "j": []}
    for tag, eng in (("t", teng), ("j", jeng)):
        orig = eng._execute_fused

        def rec(plan, _orig=orig, _tag=tag):
            plans[_tag].append((plan.width, list(plan.decode_slots),
                                [tuple(vars(c).values())
                                 for c in plan.chunk_rows]))
            return _orig(plan)
        eng._execute_fused = rec
        for p, n in zip(prompts, (6, 6, 4)):
            eng.submit(p, n)
    while teng.has_work or jeng.has_work:
        before = teng.n_fused_dispatches
        teng.step()
        jeng.step()
        assert teng.n_fused_dispatches - before in (0, 1)
    assert plans["t"] == plans["j"]
    assert teng.n_fused_dispatches == jeng.n_fused_dispatches
    assert teng.n_interleaved_decode_steps == jeng.n_interleaved_decode_steps
    assert teng.n_interleaved_decode_steps >= 1
