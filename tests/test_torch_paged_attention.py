"""K1's plain version (the port's ``paged_mixed`` on CPU tensors) vs the
JAX package: ``paged_mixed_xla``, and the Pallas ``paged_attention`` run in
interpret mode as B*W virtual decode rows (the TPU route, as
tests/test_paging.py runs it). Same seeded numpy inputs, float32.

Comparisons use VALID query rows only: for fully masked rows the JAX
versions return the mean of the gathered V, the port returns zeros (its
documented choice). Tolerance: atol = rtol = 2e-5 (float32, softmax and
summation order)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_decode_xla, paged_mixed_xla,
)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    K1, paged_decode_ref, paged_mixed,
)

TOL = 2e-5


def _case(rep, w, seed=1):
    """A decode row, a mid-chunk row, a short row with an invalid tail and
    an inactive row over a shared pool (test_paging.py's layout)."""
    rng = np.random.default_rng(seed)
    b, kv, hd, ps, npg, pool = 4, 2, 16, 8, 4, 12
    q = rng.standard_normal((b, kv, rep, w, hd)).astype(np.float32)
    kp = rng.standard_normal((pool, kv, ps, hd)).astype(np.float32)
    vp = rng.standard_normal((pool, kv, ps, hd)).astype(np.float32)
    tbl = np.full((b, npg), -1, np.int32)
    tbl[0, :3] = [4, 7, 1]          # decode row at pos 17
    tbl[1, :3] = [2, 8, 9]          # chunk row resuming at pos 8
    tbl[2, :1] = [3]                # short row
    row_pos = np.array([17, 8, 1, 0], np.int32)
    row_len = np.array([1, w, min(2, w), 0], np.int32)
    return q, kp, vp, tbl, row_pos, row_len


def _valid(row_len, shape):
    b, kv, rep, w, hd = shape
    return (np.arange(w)[None, :] < row_len[:, None])[:, None, None, :, None]


def _port(q, kp, vp, tbl, row_pos, row_len, **kw):
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, row_pos, row_len)]
    return paged_mixed(*t, **kw).numpy()


@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("rep", [1, 2])
def test_paged_mixed_matches_jax(rep, window, softcap, w):
    q, kp, vp, tbl, row_pos, row_len = _case(rep, w)
    kw = dict(window=window, softcap=softcap)
    before = K1.launches
    out = _port(q, kp, vp, tbl, row_pos, row_len, **kw)
    assert K1.launches == before            # CPU tensors: plain version
    vm = _valid(row_len, q.shape)

    ref = np.asarray(paged_mixed_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(row_pos), jnp.asarray(row_len), **kw))
    np.testing.assert_allclose(out * vm, ref * vm, atol=TOL, rtol=TOL)

    # the Pallas kernel in interpret mode, as B*W virtual decode rows
    b, kv, _, _, hd = q.shape
    qv = np.transpose(q, (0, 3, 1, 2, 4)).reshape(b * w, kv, rep, hd)
    tpos = row_pos[:, None] + np.arange(w)[None, :]
    valid = np.arange(w)[None, :] < row_len[:, None]
    lens = np.where(valid, tpos + 1, 0).reshape(-1).astype(np.int32)
    pal = np.asarray(paged_attention(
        jnp.asarray(qv), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(np.repeat(tbl, w, axis=0)), jnp.asarray(lens),
        interpret=True, **kw))
    pal = pal.reshape(b, w, kv, rep, hd).transpose(0, 2, 3, 1, 4)
    np.testing.assert_allclose(out * vm, pal * vm, atol=TOL, rtol=TOL)

    # the port's own choice for fully masked rows: zeros, finite
    assert np.isfinite(out).all()
    assert (out * ~vm == 0).all()


@pytest.mark.parametrize("window,softcap", [(None, None), (6, 30.0)])
def test_paged_decode_matches_jax(window, softcap):
    """The single-query plain version and the same queries as W=1 mixed
    rows agree with ``paged_decode_xla`` on live slots."""
    rng = np.random.default_rng(0)
    b, kv, rep, hd, ps, npg, pool = 4, 2, 2, 16, 8, 4, 12
    q = rng.standard_normal((b, kv, rep, hd)).astype(np.float32)
    kp = rng.standard_normal((pool, kv, ps, hd)).astype(np.float32)
    vp = rng.standard_normal((pool, kv, ps, hd)).astype(np.float32)
    tbl = np.full((b, npg), -1, np.int32)
    tbl[0, :3] = [4, 7, 1]
    tbl[1, :1] = [2]
    tbl[2, :4] = [0, 3, 5, 6]
    lens = np.array([18, 5, 32, 0], np.int32)
    kw = dict(window=window, softcap=softcap)
    ref = np.asarray(paged_decode_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens), **kw))
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    live = lens > 0
    mixed = paged_mixed(t[0][:, :, :, None].contiguous(), t[1], t[2], t[3],
                        (t[4] - 1).clamp(min=0), (t[4] > 0).to(torch.int32),
                        **kw)[:, :, :, 0]
    for out in (paged_decode_ref(*t, **kw).numpy(), mixed.numpy()):
        np.testing.assert_allclose(out[live], ref[live], atol=TOL, rtol=TOL)
        assert (out[~live] == 0).all()


def test_unallocated_pages_are_masked_not_wrapped():
    """-1 table entries must not wrap to the last pool page (torch and numpy
    negative indexing): a slot whose only pages are unallocated attends
    nothing, and a hole mid-sequence is skipped."""
    q, kp, vp, tbl, row_pos, row_len = _case(2, 4, seed=3)
    tbl[1, 1] = -1                              # hole under the chunk row
    out = _port(q, kp, vp, tbl, row_pos, row_len)
    ref = np.asarray(paged_mixed_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(row_pos), jnp.asarray(row_len)))
    vm = _valid(row_len, q.shape)
    np.testing.assert_allclose(out * vm, ref * vm, atol=TOL, rtol=TOL)
    tbl_none = np.full_like(tbl, -1)
    out = _port(q, kp, vp, tbl_none, row_pos, row_len)
    assert (out == 0).all()


def test_wrapper_raises_off_cpu_without_a_kernel():
    """On a non-CPU tensor the wrapper launches the kernel or raises: it
    never falls back to the plain version."""
    q, kp, vp, tbl, row_pos, row_len = _case(2, 4)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tbl, row_pos, row_len)]
    t[0] = t[0].to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        paged_mixed(*t)
