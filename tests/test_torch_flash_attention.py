"""K3's plain version (the port's ``flash_attention`` on CPU tensors) vs the
JAX package: the Pallas ``flash_attention`` through its padding wrapper
``kernels.ops.attention`` in interpret mode (positions ``arange``), and the
model's full-sequence path ``models.attention._chunked_attention`` with
explicit positions (a partial prefill's prefix-offset queries over
``[prefix ++ suffix]`` keys with ``kpos = -1`` padding, a bucketed prompt,
a non-causal case). Same seeded numpy inputs, float32.

Comparisons use query rows with at least one attended key: for a fully
masked row the JAX code returns the mean of V, the port zeros (its
documented choice). Tolerance: atol = rtol = 2e-5 (float32, softmax and
summation order)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.models.attention import _chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    K3, attend_mask, flash_attention, flash_attention_ref,
)

TOL = 2e-5


def _qkv(b, h, kv, s, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kv, t, d)).astype(np.float32),
            rng.standard_normal((b, kv, t, d)).astype(np.float32))


def _port(q, k, v, qpos, kpos, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, qpos, kpos)]
    return flash_attention(*t, **kw).numpy()


@pytest.mark.parametrize("b,h,kv,s,d,window,cap", [
    (1, 2, 2, 40, 16, None, None),      # one 128-block, ragged S
    (2, 4, 2, 40, 16, 8, None),         # GQA rep 2, sliding window
    (1, 8, 1, 200, 32, None, 30.0),     # rep 8, two blocks, softcap
    (1, 4, 1, 130, 64, 50, 20.0),       # rep 4, window + softcap
])
def test_plain_k3_matches_pallas_interpret(b, h, kv, s, d, window, cap):
    q, k, v = _qkv(b, h, kv, s, s, d, seed=s + h)
    want = np.asarray(ops.attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window, softcap=cap,
                                    interpret=True))
    pos = np.arange(s, dtype=np.int32)
    got = _port(q, k, v, pos, pos, causal=True, window=window, softcap=cap)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _prefix_positions(n_pre_pages, ps, prefix_len, s):
    """A partial prefill's positions: suffix queries at prefix_len + i over
    [gathered prefix pages (kpos -1 past prefix_len) ++ suffix] keys."""
    qpos = (prefix_len + np.arange(s)).astype(np.int32)
    t = np.arange(n_pre_pages * ps)
    kpre = np.where(t < prefix_len, t, -1).astype(np.int32)
    return qpos, np.concatenate([kpre, qpos])


def _bucket_positions(s, valid_len):
    pos = np.arange(s, dtype=np.int32)
    return pos, np.where(pos < valid_len, pos, -1).astype(np.int32)


@pytest.mark.parametrize("case", [
    # (name, h, kv, d, qpos/kpos, causal, window, cap, chunk)
    ("prefix", 4, 2, 16, _prefix_positions(4, 8, 24, 20), True, None, None,
     4),
    ("prefix-window-softcap", 8, 2, 32, _prefix_positions(4, 8, 16, 12),
     True, 10, 25.0, 4),
    ("bucket", 4, 4, 16, _bucket_positions(32, 21), True, None, None, 8),
    ("bucket-window", 4, 1, 64, _bucket_positions(64, 50), True, 16, None,
     16),
    ("noncausal-padded", 4, 2, 16,
     (np.zeros(9, np.int32), np.array([0] * 13 + [-1] * 3, np.int32)),
     False, None, None, 16),
], ids=lambda c: c[0])
def test_plain_k3_matches_chunked_attention(case):
    _, h, kv, d, (qpos, kpos), causal, window, cap, chunk = case
    s, t = len(qpos), len(kpos)
    q, k, v = _qkv(2, h, kv, s, t, d, seed=t)
    scale = d ** -0.5
    want = np.asarray(_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), window=window, cap=cap, scale=scale,
        causal=causal, chunk=chunk))
    got = _port(q, k, v, qpos, kpos, scale=scale, causal=causal,
                window=window, softcap=cap)
    rows = attend_mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                       causal=causal, window=window).any(dim=1).numpy()
    assert rows.sum() >= s - 1
    np.testing.assert_allclose(got[:, :, rows], want[:, :, rows], atol=TOL,
                               rtol=TOL)
    # a row with no attended key comes back as zeros
    assert not got[:, :, ~rows].any()


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = _qkv(1, 4, 2, 24, 24, 16, seed=3)
    pos = np.arange(24, dtype=np.int32)
    k3 = K3.launches
    got = _port(q, k, v, pos, pos, window=8, softcap=20.0)
    t = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    want = flash_attention_ref(*t, window=8, softcap=20.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert K3.launches == k3                 # CPU tensors launch nothing


def test_wrapper_rejects_bad_shapes():
    q, k, v = (torch.zeros(1, 4, 8, 16), torch.zeros(1, 3, 8, 16),
               torch.zeros(1, 3, 8, 16))
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k, v, pos, pos)       # 4 heads over 3 kv heads
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[:, :2], v[:, :2], pos[:5], pos)
