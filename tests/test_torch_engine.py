"""PyTorch port vs JAX reference: the paged, fused-step Engine, with chunked
prefill and with whole-prompt admission prefill.

The port's Engine (CPU) and the JAX ``Engine(paged=True,
chunked_prefill=...)`` step in lockstep on the same weights and the same
submissions, with a tight page pool and a small ``step_tokens`` budget so
that preemption (and, chunked, chunk interleaving) occurs. After every
step the page tables, allocator refcounts and free lists, slot states and
emitted tokens must be equal; the final tokens must equal JAX
``generate`` (and, for whole-prompt admission, the port's own
``generate``). On the CPU no kernel launches. With ``device="cuda"`` and
no GPU, every entry point raises."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.surgery import nbl_variant as jax_nbl_variant  # noqa: E402
from repro.launch.engine import Engine as JaxEngine  # noqa: E402
from repro.launch.serve import generate  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models.paging import page_bytes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    cache_from_jax, config_from_jax, from_jax_params,
)
from repro_torch.kernels import K1, K2, K3  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.serve import generate as port_generate  # noqa: E402
from repro_torch.launch.serve import serve_requests  # noqa: E402
from repro_torch.models.paging import init_paged_cache  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402

# (arch, NBL m, prompt lengths, max_new, max_len, pool pages): tight pools
# and a 6-token step budget, so chunks interleave with decode and the
# youngest request is preempted; tiny-swa decodes past its 32-token
# window, so pages that fall out of it go back to the pool
CASES = {
    "dense": ("tiny-dense", 0, (12, 9, 16, 5, 14), (8, 10, 6, 9, 7), 32, 8),
    "nbl2": ("tiny-dense", 2, (12, 9, 16, 5, 14), (8, 10, 6, 9, 7), 32, 8),
    "swa": ("tiny-swa", 0, (30, 20, 40, 9, 26), (20, 16, 10, 12, 8), 64, 16),
}


def _host_state(eng):
    return dict(
        tbl=eng.page_tbl.copy(), refs=dict(eng.allocator._refs),
        free=list(eng.allocator._free), pos=eng.slot_pos.copy(),
        chunk=eng.slot_chunk_pos.copy(),
        slots=[None if r is None else (r.rid, list(r.tokens))
               for r in eng.slot_req],
        done={rid: list(r.tokens) for rid, r in eng.finished.items()},
        queue=[r.rid for r in eng.scheduler.queue])


def _assert_same(t, j, step):
    for k in t:
        a, b = t[k], j[k]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{k} @ step {step}")
        else:
            assert a == b, f"{k} differs at step {step}: {a} vs {b}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_lockstep_with_jax(case):
    arch, m, lens, max_new, max_len, n_pages = CASES[case]
    jcfg = jax_nbl_variant(jax_config(arch), m)
    jparams = jax_init(jax.random.PRNGKey(m), jcfg)
    cfg = config_from_jax(jcfg)
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    n_layers = sum(1 for b in jcfg.blocks() if b.kind == "attn")
    kw = dict(max_len=max_len, n_slots=3, page_size=4,
              prefill_chunk_tokens=8, step_tokens=6, expected_len=8,
              cache_budget_bytes=n_pages * n_layers * page_bytes(jcfg, 4))
    jeng = JaxEngine(jcfg, jparams, paged=True, chunked_prefill=True, **kw)
    teng = Engine(cfg, params, device="cpu", **kw)
    assert teng.n_pages == jeng.n_pages == n_pages
    assert teng.n_slots == jeng.n_slots == 3
    k1, k2 = K1.launches, K2.launches
    for eng in (teng, jeng):
        for p, n in zip(prompts[:3], max_new[:3]):
            eng.submit(p, n)
    step, window_released = 0, False
    while teng.has_work or jeng.has_work:
        assert teng.step() == jeng.step()
        step += 1
        if step == 3:                          # submissions mid-stream
            for eng in (teng, jeng):
                for p, n in zip(prompts[3:], max_new[3:]):
                    eng.submit(p, n)
        _assert_same(_host_state(teng), _host_state(jeng), step)
        teng.allocator.check_invariants()
        window_released |= any(              # a decoding slot lost page 0
            r is not None and teng.slot_chunk_pos[s] < 0
            and teng.page_tbl[s, 0] < 0 for s, r in enumerate(teng.slot_req))
        assert step < 300
    assert teng.n_preemptions == jeng.n_preemptions >= 1
    assert teng.n_interleaved_decode_steps >= 1
    assert window_released == (arch == "tiny-swa")
    ts, js = teng.stats(), jeng.stats()
    for k in ("n_decode_steps", "n_prefills", "n_prefill_tokens",
              "n_fused_dispatches", "n_preemptions", "n_chunks",
              "n_interleaved_decode_steps", "peak_pages_in_use",
              "pages_in_use", "step_budget_utilization"):
        assert ts[k] == js[k], k
    for rid, (p, n) in enumerate(zip(prompts, max_new)):
        ref = np.asarray(generate(jcfg, jparams, jnp.asarray(p)[None],
                                  max_new=n))[0]
        np.testing.assert_array_equal(teng.finished[rid].tokens, ref)
    assert (K1.launches, K2.launches) == (k1, k2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_prompt_admission_lockstep_with_jax(case):
    """``Engine(chunked_prefill=False)``: admission prefills the whole
    prompt (bucketed) and emits its first token; every later token comes
    from the fused step. Lockstep with JAX ``Engine(paged=True,
    chunked_prefill=False, fused_step=True)`` under the same tight pool."""
    arch, m, lens, max_new, max_len, n_pages = CASES[case]
    jcfg = jax_nbl_variant(jax_config(arch), m)
    jparams = jax_init(jax.random.PRNGKey(m), jcfg)
    cfg = config_from_jax(jcfg)
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    n_layers = sum(1 for b in jcfg.blocks() if b.kind == "attn")
    kw = dict(max_len=max_len, n_slots=3, page_size=4, step_tokens=6,
              expected_len=8,
              cache_budget_bytes=n_pages * n_layers * page_bytes(jcfg, 4))
    jeng = JaxEngine(jcfg, jparams, paged=True, chunked_prefill=False,
                     fused_step=True, **kw)
    teng = Engine(cfg, params, chunked_prefill=False, device="cpu", **kw)
    assert teng.n_pages == jeng.n_pages == n_pages
    launches = (K1.launches, K2.launches, K3.launches)
    for eng in (teng, jeng):
        for p, n in zip(prompts[:3], max_new[:3]):
            eng.submit(p, n)
    step = 0
    while teng.has_work or jeng.has_work:
        assert teng.step() == jeng.step()
        step += 1
        if step == 3:                          # submissions mid-stream
            for eng in (teng, jeng):
                for p, n in zip(prompts[3:], max_new[3:]):
                    eng.submit(p, n)
        _assert_same(_host_state(teng), _host_state(jeng), step)
        teng.allocator.check_invariants()
        assert not (teng.slot_chunk_pos >= 0).any()     # never chunking
        assert step < 300
    assert teng.n_preemptions == jeng.n_preemptions >= 1
    ts, js = teng.stats(), jeng.stats()
    assert "n_chunks" not in ts
    for k in ("n_decode_steps", "n_prefills", "n_prefill_tokens",
              "n_fused_dispatches", "n_preemptions", "peak_pages_in_use",
              "pages_in_use", "step_budget_utilization"):
        assert ts[k] == js[k], k
    assert ts["n_prefills"] == len(prompts) + teng.n_preemptions
    for rid, (p, n) in enumerate(zip(prompts, max_new)):
        ref = np.asarray(generate(jcfg, jparams, jnp.asarray(p)[None],
                                  max_new=n))[0]
        mine = port_generate(cfg, params, p[None], max_new=n).numpy()[0]
        np.testing.assert_array_equal(mine, ref)
        np.testing.assert_array_equal(teng.finished[rid].tokens, ref)
    assert (K1.launches, K2.launches, K3.launches) == launches


def test_partial_prefill_through_the_page_table_matches_jax():
    """``Engine._run_partial_prefill`` past the start of a prompt: the span
    attends the slot's own earlier pages through a pow2 prefix table
    (the path prefix sharing and speculative verify reuse). A prompt is
    prefilled in three spans, [0, 8), [8, 12), [12, 19); logits and pools
    must equal the JAX engine's."""
    jcfg = jax_config("tiny-gemma")
    jparams = jax_init(jax.random.PRNGKey(3), jcfg)
    cfg = config_from_jax(jcfg)
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, 19).astype(np.int32)
    kw = dict(max_len=32, n_slots=2, page_size=4)
    jeng = JaxEngine(jcfg, jparams, paged=True, chunked_prefill=False, **kw)
    teng = Engine(cfg, params, chunked_prefill=False, device="cpu", **kw)
    for eng in (teng, jeng):
        req = eng.scheduler.make_request(prompt, 4)
        ids = eng.allocator.alloc(5)
        eng.page_tbl[1, :5] = ids[::-1]         # a scattered table row
        eng.slot_pages[1] = list(ids)
        eng.spans = [eng._run_partial_prefill(1, req, a, b)
                     for a, b in ((0, 8), (8, 12), (12, 19))]
    for t, j in zip(teng.spans, jeng.spans):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=1e-4)
    want = cache_from_jax(jcfg, jax.tree.map(np.asarray, jeng.cache),
                          device="cpu")
    for a, b in zip(teng.cache["layers"], want["layers"]):
        if a is not None:
            for k in ("k_pages", "v_pages"):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           atol=1e-5, rtol=1e-5)
    assert teng.n_prefills == jeng.n_prefills == 3


def test_engine_rejects_and_later_slice_modes():
    cfg = get_config("tiny-dense")
    params = init_params(cfg, seed=0, device="cpu")
    eng = Engine(cfg, params, max_len=16, n_slots=1, page_size=4,
                 device="cpu")
    rid = eng.submit(np.arange(14), 4)              # 14 + 4 > max_len
    assert eng.finished[rid].error is not None and eng.n_rejected == 1
    with pytest.raises(ValueError):
        eng.submit(np.arange(3), 0, strict=True)
    for kw in (dict(paged=False),
               dict(fused_step=False), dict(prefix_sharing=True),
               dict(drafts={1: None}), dict(obs=object())):
        with pytest.raises(NotImplementedError, match="slice"):
            Engine(cfg, params, max_len=16, n_slots=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="power of two"):
        Engine(cfg, params, max_len=16, n_slots=1, page_size=6,
               device="cpu")


def test_serve_requests_on_cpu_matches_engine():
    cfg = get_config("tiny-dense")
    params = init_params(cfg, seed=1, device="cpu")
    prompts = [np.arange(1, 6), np.arange(7, 20)]
    out, st = serve_requests(cfg, params, prompts, max_new=3, page_size=4,
                             step_tokens=8, device="cpu")
    eng = Engine(cfg, params, max_len=16, n_slots=2, page_size=4,
                 step_tokens=8, device="cpu")
    rids = [eng.submit(p, 3) for p in prompts]
    ref = eng.run()
    for o, rid in zip(out, rids):
        np.testing.assert_array_equal(o, ref[rid])
    assert st["n_fused_dispatches"] == eng.n_fused_dispatches


def test_cuda_default_raises_without_gpu(monkeypatch):
    """Every entry point defaults to the card and raises when there is
    none: nothing silently carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny-dense")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_paged_cache(cfg, 1, 16, page_size=4)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params, max_len=16, n_slots=1)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_requests(cfg, params, [np.arange(3)], max_new=2)
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_params(cfg, {"embed": np.zeros((4, 2), np.float32),
                              "groups": []})
    with pytest.raises(RuntimeError, match="cuda"):
        cache_from_jax(cfg, {"groups": []})
