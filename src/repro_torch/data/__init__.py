"""Deterministic synthetic data (the port's copy of ``repro.data``'s
numpy-only corpus; the training loader comes with the training slice)."""
from repro_torch.data.synthetic import (  # noqa: F401
    ZipfMarkov, calib_factory, lm_batches,
)
