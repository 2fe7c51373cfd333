"""PyTorch port vs JAX reference: the NBL calibration path.

The same seeded inputs go through the JAX package and the port (CPU,
float32 models on tiny-dense / tiny-gemma, JAX params converted with
``interop.from_jax_params``):

  * ``data.synthetic``: the calibration tokens are bit-identical;
  * ``forward_with_taps``: mixer and block taps within 1e-5;
  * ``update_moments`` / ``finalize`` on the same taps: rtol 1e-5 (float32
    sums in another order; atol 1e-4 on the raw sums and 1e-5 on the
    covariances for entries near zero);
  * ``cca`` / ``lmmse`` on the SAME finalized float64 moments: 1e-10 (the
    port takes ρ² from ``eigvalsh`` where the reference takes an SVD);
  * ``calibrate`` end to end: bound, cos_dist, nmse within 1e-4 relative,
    W and b within 1e-3 of max |W|, equal rankings, Theorem 3.2 per layer.

The compress → serve loop and the baselines are in
tests/test_torch_compress.py."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import calibrate as jax_calibrate  # noqa: E402
from repro.core import cca as jcca  # noqa: E402
from repro.core import lmmse as jlmmse  # noqa: E402
from repro.core import moments as jmom  # noqa: E402
from repro.core.surgery import compress as jax_compress  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models.transformer import forward_with_taps as jax_taps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cca, lmmse  # noqa: E402
from repro_torch.core.calibrate import calibrate  # noqa: E402
from repro_torch.core.moments import (  # noqa: E402
    finalize, init_moments, merge_moments, update_moments,
)
from repro_torch.core.selection import rank_layers  # noqa: E402
from repro_torch.core.surgery import compress  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.interop import config_from_jax, from_jax_params  # noqa: E402
from repro_torch.kernels import K4  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    forward_with_taps, init_params,
)


def _model(arch="tiny-dense", nbl_layers=()):
    """JAX (cfg, params) and the port's twin (cfg, params on the CPU)."""
    jcfg = jax_config(arch)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    if nbl_layers:
        rng = np.random.default_rng(4)
        d = jcfg.d_model
        maps = {i: ((rng.standard_normal((d, d)) * d ** -0.5)
                    .astype(np.float32),
                    (rng.standard_normal(d) * 0.1).astype(np.float32))
                for i in nbl_layers}
        jcfg, jparams = jax_compress(jcfg, jparams, nbl_layers, "nbl", maps)
    params = from_jax_params(jcfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, config_from_jax(jcfg), params


@pytest.fixture(scope="module")
def dense():
    return _model()


# ------------------------------------------------------------------ data ----

@pytest.mark.parametrize("batch,seq,n_batches,seed", [
    (4, 128, 8, 1234), (2, 33, 3, 7), (1, 1, 2, 0)])
def test_calib_factory_tokens_bit_identical(batch, seq, n_batches, seed):
    jcfg = jax_config("tiny-dense")
    cfg = config_from_jax(jcfg)
    kw = dict(batch=batch, seq=seq, n_batches=n_batches, seed=seed)
    mine = list(synthetic.calib_factory(cfg, **kw)())
    ref = list(jsyn.calib_factory(jcfg, **kw)())
    assert len(mine) == len(ref) == n_batches
    for a, b in zip(mine, ref):
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_zipf_markov_process_identical():
    a, b = synthetic.ZipfMarkov(512, seed=3), jsyn.ZipfMarkov(512, seed=3)
    np.testing.assert_array_equal(a.succ, b.succ)
    np.testing.assert_array_equal(a.marginal, b.marginal)
    np.testing.assert_array_equal(a.sample(3, 40, 11), b.sample(3, 40, 11))
    la = list(synthetic.lm_batches(512, 2, 16, 2, seed=5, start_step=3))
    lb = list(jsyn.lm_batches(512, 2, 16, 2, seed=5, start_step=3))
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["labels"], y["labels"])


# ------------------------------------------------------------------ taps ----

@pytest.mark.parametrize("arch,nbl,tap_block", [
    ("tiny-dense", (), False), ("tiny-dense", (), True),
    ("tiny-gemma", (), False), ("tiny-dense", (1, 4), False),
    ("tiny-dense", (1, 4), True)])
def test_forward_with_taps_matches_jax(arch, nbl, tap_block):
    jcfg, jparams, cfg, params = _model(arch, nbl)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    layers = tuple(range(cfg.n_blocks))
    jlog, jt = jax_taps(jcfg, jparams, tokens, tap_layers=layers,
                        tap_block=tap_block, need_logits=True)
    log, t = forward_with_taps(cfg, params, torch.from_numpy(tokens),
                               tap_layers=layers, tap_block=tap_block,
                               need_logits=True)
    assert sorted(t) == sorted(jt)          # NBL layers have no mixer tap
    if not tap_block:
        assert sorted(t) == cfg.attn_layer_indices()
    for i in jt:
        for mine, ref in zip(t[i], jt[i]):
            assert mine.dtype == torch.float32
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------------------- moments ----

@pytest.fixture(scope="module")
def taps_np(dense):
    """JAX mixer taps of every layer on three (2, 64) batches, as numpy:
    {layer: [(x, y), ...]}."""
    jcfg, jparams, _, _ = dense
    fac = jsyn.calib_factory(jcfg, batch=2, seq=64, n_batches=3)
    out = {i: [] for i in range(jcfg.n_blocks)}
    for b in fac():
        _, t = jax_taps(jcfg, jparams, b["tokens"], tap_layers=tuple(out))
        for i in out:
            out[i].append(tuple(np.array(a) for a in t[i]))
    return out


def test_update_moments_and_finalize_match_jax(taps_np):
    taps = taps_np[2]
    jm = jmom.init_moments(64, 64)
    tm = init_moments(64, 64, device="cpu")
    K4.reset()
    for x, y in taps:
        jm = jmom.update_moments(jm, x, y)
        assert update_moments(tm, torch.from_numpy(x),
                              torch.from_numpy(y)) is tm     # in place
    assert K4.launches == 0                  # plain version on the CPU
    jm = jax.device_get(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    jf, tf = jmom.finalize(jm), finalize(tm)
    for k in jf:
        if k in ("n", "cos_mean"):
            assert tf[k] == pytest.approx(jf[k], rel=1e-6)
        else:
            assert tf[k].dtype == torch.float64
            np.testing.assert_allclose(tf[k].numpy(), jf[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_merge_moments_is_the_sum_of_shards(taps_np):
    (x1, y1), (x2, y2) = taps_np[3][:2]
    whole = init_moments(64, 64, device="cpu")
    a, b = init_moments(64, 64, device="cpu"), init_moments(64, 64,
                                                           device="cpu")
    for x, y in ((x1, y1), (x2, y2)):
        update_moments(whole, torch.from_numpy(x), torch.from_numpy(y))
    update_moments(a, torch.from_numpy(x1), torch.from_numpy(y1))
    update_moments(b, torch.from_numpy(x2), torch.from_numpy(y2))
    merged = merge_moments(a, b)
    for k in whole:
        torch.testing.assert_close(merged[k], whole[k], rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ cca, lmmse ----

def _to_torch(fin):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in fin.items()}


@pytest.mark.parametrize("layer", [0, 3, 5])
def test_cca_and_lmmse_match_jax_on_same_moments(taps_np, layer):
    jm = jmom.init_moments(64, 64)
    for x, y in taps_np[layer]:
        jm = jmom.update_moments(jm, x, y)
    fin = jmom.finalize(jax.device_get(jm))
    tfin = _to_torch(fin)
    jb, jrho = jcca.cca_bound_from_moments(fin)
    tb, trho = cca.cca_bound_from_moments(tfin)
    assert tb == pytest.approx(jb, abs=1e-10)
    np.testing.assert_allclose(trho.numpy() ** 2, jrho ** 2, atol=1e-10)
    np.testing.assert_allclose(trho.numpy(), jrho, atol=1e-10)
    np.testing.assert_allclose(cca.inv_sqrt_psd(tfin["cxx"]).numpy(),
                               jcca.inv_sqrt_psd(fin["cxx"]), atol=1e-10)
    jw, jbias = jlmmse.lmmse_from_moments(fin)
    tw, tbias = lmmse.lmmse_from_moments(tfin)
    assert tw.dtype == tbias.dtype == torch.float64
    scale = np.abs(jw).max()
    np.testing.assert_allclose(tw.numpy(), jw, atol=1e-10 * scale)
    np.testing.assert_allclose(tbias.numpy(), jbias, atol=1e-10 * scale)
    assert lmmse.lmmse_mse(tfin, tw) == pytest.approx(
        jlmmse.lmmse_mse(fin, jw), abs=1e-10)


@pytest.mark.parametrize("d_out,d_in", [(5, 9), (9, 5), (7, 7)])
def test_canonical_correlations_rectangular(d_out, d_in):
    """min(d_out, d_in) correlations either way round, as the SVD gives,
    and the Theorem 3.2 bound with its (h_out - r) term."""
    rng = np.random.default_rng(d_out * 10 + d_in)
    n = 200
    x = rng.standard_normal((n, d_in))
    y = x @ rng.standard_normal((d_in, d_out)) * 0.3 \
        + rng.standard_normal((n, d_out))
    c = np.cov(np.concatenate([x, y], 1).T)
    cxx, cyy, cyx = c[:d_in, :d_in], c[d_in:, d_in:], c[d_in:, :d_in]
    want = jcca.canonical_correlations(cxx, cyx, cyy)
    got = cca.canonical_correlations(*(torch.from_numpy(a)
                                       for a in (cxx, cyx, cyy)))
    assert got.shape == want.shape == (min(d_out, d_in),)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    assert cca.nmse_bound(got, d_out, d_in) == pytest.approx(
        jcca.nmse_bound(want, d_out, d_in), abs=1e-10)


def test_nmse_bound_underdetermined_term():
    rho = torch.tensor([1.0, 1.0], dtype=torch.float64)
    assert cca.nmse_bound(rho, h_out=5, h_in=2) == pytest.approx(3.0)
    assert cca.nmse_bound(rho, h_out=2, h_in=2) == pytest.approx(0.0)


# ------------------------------------------------------------- calibrate ----

@pytest.fixture(scope="module")
def calibrated(dense):
    jcfg, jparams, cfg, params = dense
    jc = jax_calibrate(jcfg, jparams, jsyn.calib_factory(jcfg))
    tc = calibrate(cfg, params, synthetic.calib_factory(cfg), device="cpu")
    return jc, tc


def test_calibrate_matches_jax(calibrated):
    jc, tc = calibrated
    assert sorted(tc) == sorted(jc) == list(range(6))
    for i in jc:
        a, b = jc[i], tc[i]
        assert b.layer == i
        assert b.bound == pytest.approx(a.bound, rel=1e-4)
        assert b.cos_dist == pytest.approx(a.cos_dist, rel=1e-4)
        assert b.nmse == pytest.approx(a.nmse, rel=1e-4)
        scale = np.abs(a.w).max()
        np.testing.assert_allclose(b.w.numpy(), a.w, atol=1e-3 * scale)
        np.testing.assert_allclose(b.b.numpy(), a.b, atol=1e-3 * scale)
        np.testing.assert_allclose(b.rho.numpy(), a.rho, atol=1e-4)
        assert b.nmse <= b.bound + 1e-6                  # Theorem 3.2
    for crit in ("cca", "cosine"):
        from repro.core.selection import rank_layers as jax_rank
        assert rank_layers(tc, crit) == jax_rank(jc, crit)


def test_calibrate_chunks_replay_the_stream(dense, calibrated):
    """chunk_layers=4 replays the data twice and gives the same result."""
    _, _, cfg, params = dense
    _, tc = calibrated
    timings = {}
    tc4 = calibrate(cfg, params, synthetic.calib_factory(cfg), device="cpu",
                    chunk_layers=4, timings=timings)
    assert timings["tokens"] == 2 * 8 * 4 * 128
    assert set(timings) == {"forward_s", "moments_s", "solve_s", "tokens"}
    for i in tc:
        assert tc4[i].bound == tc[i].bound
        assert torch.equal(tc4[i].w, tc[i].w)


def test_compress_params_never_mutates_a_shared_layer_dict():
    """A shared block's dict is the same object at every position it runs:
    rewriting one position builds a new dict and leaves the others."""
    cfg = get_config("tiny-dense")
    params = init_params(cfg, seed=1, device="cpu")
    layers = list(params["layers"])
    layers[2] = layers[1]                       # one dict at positions 1, 2
    params = dict(params, layers=layers)
    shared, keys = layers[1], set(layers[1])
    d = cfg.d_model
    w, b = torch.eye(d, dtype=torch.float64), torch.zeros(d,
                                                          dtype=torch.float64)
    for mode, lin in (("nbl", {1: (w, b)}), ("drop", None),
                      ("nbl_block", {1: (w, b)}), ("drop_block", None)):
        new_cfg, new = compress(cfg, params, [1], mode, lin)
        assert new["layers"][2] is shared and set(shared) == keys
        assert new["layers"][1] is not shared
        assert params["layers"][1] is shared
        assert new["layers"][0] is params["layers"][0]
        assert new_cfg.blocks()[1].kind == mode
    _, new = compress(cfg, params, [1], "nbl", {1: (w * 2, b + 1)})
    torch.testing.assert_close(new["layers"][1]["mixer"]["w"],
                               2 * torch.eye(d))   # stores Wᵀ, param dtype
    assert new["layers"][1]["ffn"] is shared["ffn"]


def test_calibrate_defaults_to_cuda_and_refuses_other_devices():
    """Like every entry point, calibrate runs on "cuda" unless asked for the
    CPU: here (no card) that raises; with a card, CPU params raise."""
    cfg = get_config("tiny-dense")
    params = init_params(cfg, seed=1, device="cpu")
    fac = synthetic.calib_factory(cfg, n_batches=1)
    with pytest.raises((RuntimeError, ValueError)):
        calibrate(cfg, params, fac)
