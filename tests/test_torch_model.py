"""PyTorch port vs JAX reference: ``transformer.fused_step``.

Two consecutive fused steps (a chunk step of width 16, then a mixed
decode + chunk step of width 4) on the same weights (JAX params through
``interop.from_jax_params``), the same tokens and the same page table:
the logits of every active row and the written page pools must match.
Configs: tiny-dense, tiny-swa, tiny-gemma, and tiny-dense after
``repro.core.surgery.compress`` with 2 NBL layers (a multi-group stack
plan). Float32; tolerances: logits atol = rtol = 1e-4, pools 1e-5.
Inactive rows (row_len 0) are not compared: the JAX attention returns the
mean of V for a fully masked row, the port zeros."""
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
from repro.models import fused_step as jax_fused_step  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models.paging import init_paged_cache as jax_cache  # noqa: E402
from repro_torch.configs.base import Block, StackGroup  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    cache_from_jax, config_from_jax, from_jax_params,
)
from repro_torch.kernels import K1, K2  # noqa: E402
from repro_torch.models.transformer import fused_step  # noqa: E402

PS, N_PAGES, MAX_LEN = 8, 12, 32


def _model(arch, nbl_layers=()):
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
    return jcfg, jparams


def _steps(vocab):
    """(tokens, row_pos, row_len) of two consecutive steps over the table
    below: a chunk step, then decode + chunk + short rows."""
    rng = np.random.default_rng(9)
    t1 = rng.integers(0, vocab, (4, 16)).astype(np.int32)
    t2 = rng.integers(0, vocab, (4, 4)).astype(np.int32)
    return [(t1, np.array([0, 0, 0, 0], np.int32),
             np.array([16, 8, 3, 0], np.int32)),
            (t2, np.array([16, 8, 3, 0], np.int32),
             np.array([1, 4, 1, 0], np.int32))]


@pytest.mark.parametrize("arch,nbl", [
    ("tiny-dense", ()), ("tiny-swa", ()), ("tiny-gemma", ()),
    ("tiny-dense", (3, 5)),
])
def test_fused_step_matches_jax(arch, nbl):
    jcfg, jparams = _model(arch, nbl)
    cfg = config_from_jax(jcfg)
    if nbl:
        assert len(cfg.stack) > 1                 # multi-group plan
        assert [b.kind for b in cfg.blocks()].count("nbl") == 2
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    jc = jax_cache(jcfg, 4, MAX_LEN, page_size=PS, n_pages=N_PAGES)
    tc = cache_from_jax(jcfg, jax.tree.map(np.asarray, jc), device="cpu")
    tbl = np.full((4, MAX_LEN // PS), -1, np.int32)
    tbl[0, :3] = [4, 7, 1]
    tbl[1, :2] = [2, 8]
    tbl[2, :1] = [3]
    jstep = jax.jit(functools.partial(jax_fused_step, jcfg))
    k1, k2 = K1.launches, K2.launches
    for tokens, row_pos, row_len in _steps(jcfg.vocab_size):
        jl, jc = jstep(jparams, jnp.asarray(tokens), jc, jnp.asarray(row_pos),
                       jnp.asarray(row_len), jnp.asarray(tbl))
        tl, tc = fused_step(cfg, params, torch.from_numpy(tokens), tc,
                            torch.from_numpy(row_pos),
                            torch.from_numpy(row_len), torch.from_numpy(tbl))
        assert tl.dtype == torch.float32
        assert tl.shape == (4, 1, jcfg.vocab_size)
        live = row_len > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, rtol=1e-4)
        want = cache_from_jax(jcfg, jax.tree.map(np.asarray, jc),
                              device="cpu")
        for a, b in zip(tc["layers"], want["layers"]):
            assert (a is None) == (b is None)
            if a is not None:
                for k in ("k_pages", "v_pages"):
                    np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                               atol=1e-5, rtol=1e-5)
    # CPU tensors run the plain versions: no kernel launched
    assert (K1.launches, K2.launches) == (k1, k2)


def test_from_jax_params_unstacks_shared_and_scanned():
    """Scanned leaves are unstacked along ``repeat``; a shared block's one
    copy becomes the same dict at every position it runs."""
    attn = Block(kind="attn")
    shared = Block(kind="attn", shared=True)
    nbl = Block(kind="nbl")
    stack = (StackGroup(unit=(attn, shared), repeat=2),
             StackGroup(unit=(nbl,), repeat=3))

    class Cfg:                                   # only .stack is read
        pass
    cfg = Cfg()
    cfg.stack = stack
    rng = np.random.default_rng(0)
    w_attn = rng.standard_normal((2, 4, 4)).astype(np.float32)
    w_shared = rng.standard_normal((4, 4)).astype(np.float32)
    w_nbl = rng.standard_normal((3, 4, 4)).astype(np.float32)
    params_np = {
        "embed": np.zeros((8, 4), np.float32),
        "final_norm": np.zeros(4, np.float32),
        "groups": [
            {"scanned": [{"mixer": {"wq": w_attn}}, None],
             "shared": [None, {"mixer": {"wq": w_shared}}]},
            {"scanned": [{"mixer": {"w": w_nbl}}], "shared": [None]},
        ],
    }
    p = from_jax_params(cfg, params_np, device="cpu")
    layers = p["layers"]
    assert len(layers) == 7
    np.testing.assert_array_equal(layers[0]["mixer"]["wq"], w_attn[0])
    np.testing.assert_array_equal(layers[2]["mixer"]["wq"], w_attn[1])
    assert layers[1] is layers[3]                # one shared copy
    np.testing.assert_array_equal(layers[1]["mixer"]["wq"], w_shared)
    for r in range(3):
        np.testing.assert_array_equal(layers[4 + r]["mixer"]["w"], w_nbl[r])
