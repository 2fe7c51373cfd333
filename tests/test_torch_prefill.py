"""PyTorch port vs JAX reference: the full-sequence path (``apply``,
``prefill``), ``decode_step`` on the monolithic and the paged cache, and
``paging.assign_pages``.

Same weights (JAX params through ``interop.from_jax_params``), the same
seeded tokens; configs tiny-dense, tiny-swa (prompts longer than its
32-token window, so the ring compacts), tiny-gemma (local/global windows,
softcaps) and tiny-dense after ``repro.core.surgery.compress`` with 2 NBL
layers. Prefill cases: plain with a wider ring, bucketed (right-padded,
``valid_len``) with ``n_logits=3``, paged, and partial (suffix over a
paged prefix through ``prefix_tbl`` / ``prefix_len``). Float32;
tolerances: logits atol = rtol = 1e-4, caches and pools 1e-5. On the CPU
no kernel launches."""
from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.surgery import compress  # noqa: E402
from repro.models import apply as jax_apply  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.paging import assign_pages as jax_assign  # noqa: E402
from repro.models.paging import init_paged_cache as jax_cache  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    cache_from_jax, config_from_jax, from_jax_params,
)
from repro_torch.kernels import K1, K2, K3  # noqa: E402
from repro_torch.models.paging import (  # noqa: E402
    assign_pages, sanitize_page_ids,
)
from repro_torch.models.transformer import (  # noqa: E402
    apply, decode_step, prefill,
)

LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
PS, N_PAGES, N_LP = 8, 12, 6
ARCHS = [("tiny-dense", ()), ("tiny-swa", ()), ("tiny-gemma", ()),
         ("tiny-dense", (3, 5))]


@functools.lru_cache(maxsize=None)
def _model(arch, nbl_layers):
    """(jcfg, jparams, cfg, params), built once per module: no test
    mutates the weights."""
    jcfg = jax_config(arch)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    if nbl_layers:
        rng = np.random.default_rng(4)
        d = jcfg.d_model
        maps = {i: ((rng.standard_normal((d, d)) * d ** -0.5)
                    .astype(np.float32),
                    (rng.standard_normal(d) * 0.1).astype(np.float32))
                for i in nbl_layers}
        jcfg, jparams = compress(jcfg, jparams, nbl_layers, "nbl", maps)
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, config_from_jax(jcfg), params


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    """One jit of the JAX decode step per config, shared by its steps."""
    return jax.jit(functools.partial(jax_decode_step, jcfg))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close_logits(t, j):
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def _close_cache(jcfg, tcache, jcache):
    want = cache_from_jax(jcfg, jax.tree.map(np.asarray, jcache),
                          device="cpu")
    assert len(tcache["layers"]) == len(want["layers"])
    for a, b in zip(tcache["layers"], want["layers"]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.keys() == b.keys()
        for k in a:
            if k == "kpos":
                np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
            else:
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           atol=CACHE_TOL, rtol=CACHE_TOL)


@pytest.mark.parametrize("arch,nbl", ARCHS)
def test_prefill_then_decode_matches_jax(arch, nbl):
    """Plain prefill of a 40-token batch into a 46-wide ring, then three
    scalar-position decode steps."""
    jcfg, jparams, cfg, params = _model(arch, nbl)
    toks = _tokens(jcfg.vocab_size, (2, 40), seed=1)
    k3 = (K1.launches, K2.launches, K3.launches)
    jl, jc = jax_prefill(jcfg, jparams, jnp.asarray(toks), cache_len=46)
    tl, tc = prefill(cfg, params, torch.from_numpy(toks), cache_len=46)
    assert tl.shape == (2, 1, jcfg.vocab_size)
    _close_logits(tl, jl)
    _close_cache(jcfg, tc, jc)
    nxt = _tokens(jcfg.vocab_size, (3, 2, 1), seed=2)
    for i in range(3):
        jl, jc = _jax_decode(jcfg)(jparams, jnp.asarray(nxt[i]), jc,
                                   jnp.int32(40 + i))
        tl, tc = decode_step(cfg, params, torch.from_numpy(nxt[i]), tc, 40 + i)
        _close_logits(tl, jl)
        _close_cache(jcfg, tc, jc)
    assert (K1.launches, K2.launches, K3.launches) == k3


@pytest.mark.parametrize("arch,nbl", ARCHS)
def test_bucketed_prefill_and_apply_match_jax(arch, nbl):
    """A 21-token prompt right-padded to a 32 bucket: ``valid_len`` masks
    the padding, ``n_logits=3`` returns the last three valid positions;
    paged (position-aligned) and ring layouts. Then ``apply``."""
    jcfg, jparams, cfg, params = _model(arch, nbl)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :21] = _tokens(jcfg.vocab_size, (21,), seed=3)
    for paged in (True, False):
        jl, jc = jax_prefill(jcfg, jparams, jnp.asarray(toks), cache_len=32,
                             paged=paged, valid_len=jnp.int32(21),
                             n_logits=3)
        tl, tc = prefill(cfg, params, torch.from_numpy(toks), cache_len=32,
                         paged=paged, valid_len=21, n_logits=3)
        assert tl.shape == (1, 3, jcfg.vocab_size)
        _close_logits(tl, jl)
        _close_cache(jcfg, tc, jc)
    toks = _tokens(jcfg.vocab_size, (2, 36), seed=4)
    jl, _ = jax_apply(jcfg, jparams, jnp.asarray(toks))
    tl, aux = apply(cfg, params, torch.from_numpy(toks))
    assert tl.shape == (2, 36, jcfg.vocab_size) and float(aux) == 0.0
    _close_logits(tl, jl)


@pytest.mark.parametrize("arch,nbl", ARCHS)
def test_paged_admission_partial_prefill_and_decode_match_jax(arch, nbl):
    """A bucketed paged prefill (16 tokens in a 32 bucket) assigned to
    pages [5, 2] (the padding pages' ids are -1 and must be dropped), a
    partial prefill of the next 8 tokens over that 16-token prefix through
    ``prefix_tbl`` into page 7, then paged decode steps with an inactive
    row riding along."""
    jcfg, jparams, cfg, params = _model(arch, nbl)
    jpool = jax_cache(jcfg, 2, N_LP * PS, page_size=PS, n_pages=N_PAGES)
    rng = np.random.default_rng(5)
    jpool = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jpool)
    tpool = cache_from_jax(jcfg, jax.tree.map(np.asarray, jpool),
                           device="cpu")
    prompt = _tokens(jcfg.vocab_size, (24,), seed=6)
    row = np.full(N_LP, -1, np.int32)
    row[:2] = [5, 2]

    toks = np.zeros((1, 32), np.int32)
    toks[0, :16] = prompt[:16]
    jl, jc = jax_prefill(jcfg, jparams, jnp.asarray(toks), cache_len=32,
                         paged=True, valid_len=jnp.int32(16))
    tl, tc = prefill(cfg, params, torch.from_numpy(toks), cache_len=32,
                     paged=True, valid_len=16)
    _close_logits(tl, jl)
    jpool = jax_assign(jcfg, jpool, jc, 0, jnp.asarray(row), page_size=PS)
    assign_pages(cfg, tpool, tc, torch.from_numpy(row), page_size=PS)
    _close_cache(jcfg, tpool, jpool)

    # pages 5 and 2 hold positions 0..15; the suffix 16..23 goes to page 7
    toks = prompt[None, 16:24].copy()
    ptbl = np.array([5, 2], np.int32)
    jl, jc = jax_prefill(jcfg, jparams, jnp.asarray(toks), cache_len=8,
                         paged=True, prefix_cache=jpool,
                         prefix_tbl=jnp.asarray(ptbl),
                         prefix_len=jnp.int32(16))
    tl, tc = prefill(cfg, params, torch.from_numpy(toks), cache_len=8,
                     paged=True, prefix_cache=tpool,
                     prefix_tbl=torch.from_numpy(ptbl), prefix_len=16)
    _close_logits(tl, jl)
    _close_cache(jcfg, tc, jc)
    tail = np.array([7, -1], np.int32)
    jpool = jax_assign(jcfg, jpool, jc, 0, jnp.asarray(tail), page_size=PS)
    assign_pages(cfg, tpool, tc, torch.from_numpy(tail), page_size=PS)
    _close_cache(jcfg, tpool, jpool)

    tbl = np.full((2, N_LP), -1, np.int32)
    tbl[0, :4] = [5, 2, 7, 9]
    nxt = _tokens(jcfg.vocab_size, (3, 2, 1), seed=7)
    for i in range(3):
        pos = np.array([24 + i, -1], np.int32)
        jl, jpool = _jax_decode(jcfg)(jparams, jnp.asarray(nxt[i]), jpool,
                                      jnp.asarray(pos), jnp.asarray(tbl))
        tl, tpool = decode_step(cfg, params, torch.from_numpy(nxt[i]), tpool,
                                torch.from_numpy(pos),
                                page_tbl=torch.from_numpy(tbl))
        _close_logits(tl[:1], np.asarray(jl)[:1])     # row 1 is inactive
        _close_cache(jcfg, tpool, jpool)


def test_sanitize_page_ids_matches_jax():
    from repro.models.paging import sanitize_page_ids as jax_sanitize
    ids = np.array([3, -1, 0, 11, -1], np.int32)
    want = np.asarray(jax_sanitize(jnp.asarray(ids), 12))
    got = sanitize_page_ids(torch.from_numpy(ids), 12)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampling_shape_and_range():
    """``generate(greedy=False)`` draws from a torch generator: its tokens
    cannot equal JAX's, so only shape, range, determinism per seed and the
    argmax first token (as in the JAX loop) are held."""
    from repro_torch.launch.serve import generate
    _, _, cfg, params = _model("tiny-dense", ())
    toks = _tokens(cfg.vocab_size, (3, 9), seed=8)
    greedy = generate(cfg, params, toks, max_new=6)
    draws = [generate(cfg, params, toks, max_new=6, greedy=False, seed=s)
             for s in (1, 1, 2)]
    for d in draws:
        assert d.shape == (3, 6) and d.dtype == torch.int32
        assert int(d.min()) >= 0 and int(d.max()) < cfg.vocab_size
        np.testing.assert_array_equal(d[:, 0].numpy(), greedy[:, 0].numpy())
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    assert not np.array_equal(draws[0].numpy(), draws[2].numpy())
