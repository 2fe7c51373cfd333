"""PyTorch port vs JAX reference: NBL compression end to end, its
ablations and baselines, and the compress → serve loop.

On tiny-dense (float32, JAX params converted with
``interop.from_jax_params``, the same ``calib_factory`` batches):

  * ``nbl_compress(m=2)`` selects the same layers as the JAX package; the
    compressed params equal the JAX compressed params converted to the
    port (W, b within 1e-3 of max |W|, every other tensor unchanged); the
    port ``Engine``'s greedy tokens equal JAX ``generate`` on the
    JAX-compressed model;
  * ``block=True`` and ``criterion="cosine"``, ``greedy_select(m=2)``,
    ``drop_compress`` (Attn and Block DROP) and ``sleb_compress(m=1)``
    choose the same layers as the JAX package;
  * ``perplexity`` within 1e-5 relative and ``successor_accuracy`` equal.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import drop_compress as jax_drop  # noqa: E402
from repro.core import greedy_select as jax_greedy  # noqa: E402
from repro.core import nbl_compress as jax_nbl  # noqa: E402
from repro.core import sleb_compress as jax_sleb  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.eval.perplexity import perplexity as jax_ppl  # noqa: E402
from repro.eval.perplexity import successor_accuracy as jax_succ  # noqa: E402
from repro.launch.serve import generate  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro_torch.core import (  # noqa: E402
    drop_compress, greedy_select, nbl_compress, sleb_compress,
)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.eval import eval_suite, perplexity  # noqa: E402
from repro_torch.interop import config_from_jax, from_jax_params  # noqa: E402
from repro_torch.kernels import K2  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402


@pytest.fixture(scope="module")
def dense():
    jcfg = jax_config("tiny-dense")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, config_from_jax(jcfg), params


def _factories(jcfg, cfg, **kw):
    return jsyn.calib_factory(jcfg, **kw), synthetic.calib_factory(cfg, **kw)


def _port_of(jcfg, jparams):
    return config_from_jax(jcfg), from_jax_params(
        jcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _assert_params_match(mine, ref, nbl_ids):
    """Port params against the JAX compressed params converted to the
    port: NBL maps within 1e-3 of max |W|, every other tensor equal."""
    assert set(mine) == set(ref)
    assert len(mine["layers"]) == len(ref["layers"])
    for i, (a, b) in enumerate(zip(mine["layers"], ref["layers"])):
        assert set(a) == set(b), i
        for k in a:
            if i in nbl_ids and k == "mixer":
                scale = b["mixer"]["w"].abs().max().item()
                for n in ("w", "b"):
                    assert a[k][n].dtype == b[k][n].dtype
                    torch.testing.assert_close(a[k][n], b[k][n], rtol=0,
                                               atol=1e-3 * scale)
            else:
                for n in a[k] if isinstance(a[k], dict) else [None]:
                    x = a[k] if n is None else a[k][n]
                    y = b[k] if n is None else b[k][n]
                    assert torch.equal(x, y), (i, k, n)


def test_nbl_compress_matches_jax_and_serves(dense):
    jcfg, jparams, cfg, params = dense
    jfac, fac = _factories(jcfg, cfg)
    jc, jp, jrep = jax_nbl(jcfg, jparams, jfac, 2)
    c, p, rep = nbl_compress(cfg, params, fac, 2, device="cpu")
    assert rep.layers == jrep.layers and len(set(rep.layers)) == 2
    assert rep.ranking == jrep.ranking
    assert rep.method == jrep.method == "Attn NBL-2 (cca)"
    for i in jrep.bounds:
        assert rep.bounds[i] == pytest.approx(jrep.bounds[i], rel=1e-4)
        assert rep.cos_dists[i] == pytest.approx(jrep.cos_dists[i], rel=1e-4)
        assert rep.nmse[i] == pytest.approx(jrep.nmse[i], rel=1e-4)
    assert "layer" in rep.summary()
    ccfg, cref = _port_of(jc, jp)
    assert c == ccfg
    _assert_params_match(p, cref, set(rep.layers))
    assert params["layers"][rep.layers[0]]["mixer"].keys() == {
        "wq", "wk", "wv", "wo"}                     # dense params untouched

    # compress -> serve: the port engine on the port-compressed model
    # against JAX generate on the JAX-compressed model
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 21)]
    eng = Engine(c, p, max_len=40, n_slots=4, page_size=8, step_tokens=16,
                 device="cpu")
    K2.reset()
    rids = [eng.submit(pr, 8, strict=True) for pr in prompts]
    out = eng.run()
    assert K2.launches == 0                         # plain version, CPU
    for rid, pr in zip(rids, prompts):
        ref = np.asarray(generate(jc, jp, jnp.asarray(pr)[None],
                                  max_new=8))[0]
        np.testing.assert_array_equal(out[rid], ref)


@pytest.mark.parametrize("block,criterion", [(True, "cca"),
                                             (False, "cosine"),
                                             (True, "cosine")])
def test_nbl_compress_variants_match_jax(dense, block, criterion):
    jcfg, jparams, cfg, params = dense
    jfac, fac = _factories(jcfg, cfg, n_batches=4)
    jc, jp, jrep = jax_nbl(jcfg, jparams, jfac, 2, block=block,
                           criterion=criterion)
    c, p, rep = nbl_compress(cfg, params, fac, 2, block=block,
                             criterion=criterion, device="cpu")
    assert rep.layers == jrep.layers and rep.ranking == jrep.ranking
    assert rep.method == jrep.method
    ccfg, cref = _port_of(jc, jp)
    assert c == ccfg
    _assert_params_match(p, cref, set(rep.layers))


def test_greedy_select_matches_jax(dense):
    jcfg, jparams, cfg, params = dense
    jfac, fac = _factories(jcfg, cfg, n_batches=4)
    jchosen, jcal = jax_greedy(jcfg, jparams, jfac, 2)
    chosen, cal = greedy_select(cfg, params, fac, 2, device="cpu")
    assert chosen == jchosen and sorted(cal) == sorted(jcal)
    for i in cal:
        assert cal[i].bound == pytest.approx(jcal[i].bound, rel=1e-4)


@pytest.mark.parametrize("block", [False, True])
def test_drop_compress_matches_jax(dense, block):
    jcfg, jparams, cfg, params = dense
    jfac, fac = _factories(jcfg, cfg, n_batches=4)
    jc, jp, jids = jax_drop(jcfg, jparams, jfac, 2, block=block)
    c, p, ids = drop_compress(cfg, params, fac, 2, block=block, device="cpu")
    assert ids == jids
    ccfg, cref = _port_of(jc, jp)
    assert c == ccfg
    _assert_params_match(p, cref, set())


def test_sleb_and_perplexity_match_jax(dense):
    jcfg, jparams, cfg, params = dense
    jfac, fac = _factories(jcfg, cfg, batch=2, seq=32, n_batches=2)
    assert perplexity(cfg, params, fac, device="cpu") == pytest.approx(
        jax_ppl(jcfg, jparams, jfac), rel=1e-5)
    jc, jp, jremoved = jax_sleb(jcfg, jparams, jfac, 1)
    c, p, removed = sleb_compress(cfg, params, fac, 1, device="cpu")
    assert removed == jremoved and len(removed) == 1
    ccfg, cref = _port_of(jc, jp)
    assert c == ccfg
    _assert_params_match(p, cref, set())
    assert perplexity(c, p, fac, device="cpu") == pytest.approx(
        jax_ppl(jc, jp, jfac), rel=1e-5)
    succ = jsyn.ZipfMarkov(cfg.vocab_size, seed=1234).succ
    suite = eval_suite(c, p, fac, succ, device="cpu")
    assert suite["succ_acc"] == jax_succ(jc, jp, jfac, succ)
    assert set(suite) == {"ppl", "succ_acc"}
