"""K2's plain version (the port's ``nbl_linear`` on CPU tensors) vs the
JAX Pallas ``nbl_linear`` in interpret mode, with and without the
residual. Same seeded numpy inputs. Tolerances: float32 atol = rtol =
1e-5 (summation order); bfloat16 atol = rtol = 1e-2 (both add bias and
residual in float32 and round once, so they differ by at most about one
bf16 ulp)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.nbl_linear import nbl_linear as jax_nbl_linear  # noqa: E402
from repro_torch.kernels.nbl_linear import K2, nbl_linear  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("m", [32, 256])
def test_nbl_linear_matches_pallas_interpret(m, residual, dtype):
    x, w, b = _inputs(m, 64, 64)
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_nbl_linear(jnp.asarray(x, jt), jnp.asarray(w, jt),
                         jnp.asarray(b, jt), residual=residual,
                         block_m=32, block_n=64, block_k=32, interpret=True)
    before = K2.launches
    out = nbl_linear(torch.from_numpy(x).to(tt), torch.from_numpy(w).to(tt),
                     torch.from_numpy(b).to(tt), residual=residual)
    assert K2.launches == before            # CPU tensors: plain version
    assert out.dtype == tt and out.shape == (m, 64)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_nbl_linear_ragged_and_rectangular():
    """Ragged M and a rectangular W (no residual) need no padding: the
    plain version equals the float32 formula."""
    x, w, b = _inputs(13, 48, 40, seed=1)
    out = nbl_linear(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), residual=False)
    np.testing.assert_allclose(out.numpy(), x @ w + b, atol=1e-5, rtol=1e-5)


def test_nbl_linear_matches_model_block_at_f32():
    """At float32 the kernel's f32 epilogue equals the JAX model's
    ``x + (x @ W + b)`` (transformer.py) up to summation order."""
    x, w, b = _inputs(24, 64, 64, seed=2)
    xj = jnp.asarray(x)
    model = xj + (xj @ jnp.asarray(w) + jnp.asarray(b))
    out = nbl_linear(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(model),
                               atol=1e-5, rtol=1e-5)


def test_nbl_linear_validates_inputs():
    x, w, b = (torch.from_numpy(a) for a in _inputs(8, 64, 32))
    with pytest.raises(ValueError, match="square"):
        nbl_linear(x, w, b, residual=True)
    with pytest.raises(ValueError, match="dtype"):
        nbl_linear(x, w.double(), b, residual=False)
    with pytest.raises(ValueError, match="CUDA"):
        nbl_linear(x.to("meta"), w.to("meta"), b.to("meta"), residual=False)
