"""PyTorch port vs JAX reference: primitive layers (RMSNorm, RoPE, gated
MLP, softcap, embeddings) on the same seeded numpy inputs, float32.
Tolerance: atol 1e-5 (float32 transcendental / reduction order)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=atol, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 16)])
def test_rmsnorm_matches_jax(shape):
    rng = _rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    w = rng.standard_normal(shape[-1]).astype(np.float32) * 0.1
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_split_halves_matches_jax(theta):
    """RoPE rotates split halves (not interleaved pairs), per-row
    positions broadcast over heads as in the fused step."""
    rng = _rng(2)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 1, 6)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "geglu"])
def test_gated_mlp_matches_jax(act):
    """silu (SwiGLU) and geglu with tanh-approximate GELU."""
    rng = _rng(3)
    d, ff = 16, 32
    p = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                      ("w_down", (ff, d)))}
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    out = tl.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), act)
    ref = jl.mlp({k: jnp.asarray(v) for k, v in p.items()},
                 jnp.asarray(x), act)
    _close(out, ref)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap_matches_jax(cap):
    x = _rng(4).standard_normal((4, 7)).astype(np.float32) * 50
    _close(tl.softcap(torch.from_numpy(x), cap),
           jl.softcap(jnp.asarray(x), cap))


def test_embed_tokens_matches_jax():
    rng = _rng(5)
    table = rng.standard_normal((32, 8)).astype(np.float32)
    toks = rng.integers(0, 32, (3, 4)).astype(np.int64)
    _close(tl.embed_tokens(torch.from_numpy(table), torch.from_numpy(toks),
                           torch.float32),
           jl.embed_tokens(jnp.asarray(table), jnp.asarray(toks),
                           jnp.float32))
