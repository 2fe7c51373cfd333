"""PyTorch port vs JAX reference: K4 ``cov_accum`` (acc += yᵀx).

On the CPU the port's wrapper runs its plain version (``cov_accum_ref``)
and updates ``acc`` in place. It is held against the Pallas kernel in
interpret mode (``repro.kernels.cov_accum.cov_accum``), against the JAX
oracle ``repro.kernels.ref.cov_accum_ref`` and, for ragged T, against the
JAX padding wrapper ``repro.kernels.ops.cov_update``, at the JAX tests'
shapes. Tolerance as in tests/test_kernels.py: atol 2e-3, rtol 1e-4
(float32 sums of up to 1024 products in another order). The CUDA kernel
itself is held against the plain version on the card by
``chip_smoke.py`` (phase ``k4``)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cov_accum import cov_accum as jax_cov_accum  # noqa: E402
from repro.kernels.ops import cov_update  # noqa: E402
from repro_torch.kernels import K4  # noqa: E402
from repro_torch.kernels.cov_accum import cov_accum, cov_accum_ref  # noqa: E402

TOL = dict(atol=2e-3, rtol=1e-4)


def _inputs(t, dx, dy, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, dx)).astype(np.float32),
            rng.standard_normal((t, dy)).astype(np.float32),
            rng.standard_normal((dy, dx)).astype(np.float32))


@pytest.mark.parametrize("t,dx,dy", [(512, 256, 256), (1024, 256, 512),
                                     (512, 512, 256)])
def test_plain_k4_matches_pallas_and_oracle(t, dx, dy):
    x, y, acc = _inputs(t, dx, dy)
    want = np.asarray(jax_cov_accum(jnp.asarray(acc), jnp.asarray(x),
                                    jnp.asarray(y), interpret=True))
    oracle = np.asarray(jref.cov_accum_ref(jnp.asarray(acc), jnp.asarray(x),
                                           jnp.asarray(y)))
    a = torch.from_numpy(acc.copy())
    out = cov_accum(a, torch.from_numpy(x), torch.from_numpy(y))
    assert out is a                                   # updated in place
    np.testing.assert_allclose(a.numpy(), want, **TOL)
    np.testing.assert_allclose(a.numpy(), oracle, **TOL)


@pytest.mark.parametrize("t,dx,dy", [(300, 256, 256), (300, 256, 512),
                                     (1, 128, 64)])
def test_plain_k4_ragged_tokens_match_padding_wrapper(t, dx, dy):
    """The reference pads T to 512 with zero rows; the port needs none."""
    x, y, acc = _inputs(t, dx, dy, seed=1)
    want = np.asarray(cov_update(jnp.asarray(acc), jnp.asarray(x),
                                 jnp.asarray(y), interpret=True))
    a = torch.from_numpy(acc.copy())
    cov_accum(a, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(a.numpy(), want, **TOL)


def test_plain_k4_bf16_inputs():
    """bf16 x and y are converted to float32 before the product, as in the
    Pallas kernel: the same bf16 values give the same sums."""
    x, y, acc = _inputs(512, 256, 512, seed=2)
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    want = np.asarray(jax_cov_accum(jnp.asarray(acc), xb, yb, interpret=True))
    a = torch.from_numpy(acc.copy())
    cov_accum(a, torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16())
    np.testing.assert_allclose(a.numpy(), want, **TOL)


def test_plain_k4_gram_and_running_sum():
    """y=None is the Gram update; two calls over the halves of the tokens
    equal one call over all of them (the reference's running-sum test)."""
    x, _, _ = _inputs(512, 256, 256, seed=3)
    want = np.asarray(jref.cov_accum_ref(jnp.zeros((256, 256)),
                                         jnp.asarray(x)))
    halves = jnp.zeros((256, 256))
    for part in (x[:256], x[256:]):
        halves = jax_cov_accum(halves, jnp.asarray(part.copy()),
                               interpret=True)
    a = torch.zeros(256, 256)
    for part in (x[:256], x[256:]):
        cov_accum(a, torch.from_numpy(part.copy()))
    np.testing.assert_allclose(a.numpy(), want, **TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(halves), **TOL)
    np.testing.assert_allclose(a.numpy(), a.numpy().T, atol=1e-4)


def test_wrapper_plain_version_launches_nothing_and_validates():
    K4.reset()
    x = torch.randn(16, 8)
    acc = torch.zeros(8, 8)
    ref = cov_accum_ref(acc, x)
    assert torch.equal(cov_accum(acc, x), ref)
    assert K4.launches == 0                         # no kernel on the CPU
    with pytest.raises(ValueError):
        cov_accum(torch.zeros(8, 7), x)             # acc shape
    with pytest.raises(ValueError):
        cov_accum(torch.zeros(8, 8, dtype=torch.float64), x)
    with pytest.raises(ValueError):
        cov_accum(torch.zeros(4, 8), x, torch.randn(15, 4))   # T mismatch
