"""The paper's contribution: Neural Block Linearization (NBL), ported.

  moments    streaming (X, Y) moment accumulation (d×d sums through K4)
  cca        canonical correlations + Theorem-3.2 NMSE bound (float64)
  lmmse      Proposition-3.1 closed-form linear estimator (float64)
  calibrate  Algorithm 1/2 over a calibration stream
  selection  CCA-bound / cosine / greedy layer selection
  surgery    config + param rewriting
  drop       DROP / SLEB removal baselines
  api        nbl_compress / reports

The JAX package's ``lora_*`` (training) and ``psum_moments`` (sharded
calibration) are not in the port yet (ROADMAP.md §A).
"""
from repro_torch.core.api import CompressionReport, nbl_compress  # noqa: F401
from repro_torch.core.calibrate import (  # noqa: F401
    LayerCalib, calibrate, candidate_layers,
)
from repro_torch.core.cca import (  # noqa: F401
    canonical_correlations, cca_bound_from_moments, inv_sqrt_psd, nmse_bound,
)
from repro_torch.core.drop import drop_compress, sleb_compress  # noqa: F401
from repro_torch.core.lmmse import lmmse_from_moments, lmmse_mse  # noqa: F401
from repro_torch.core.moments import (  # noqa: F401
    finalize, init_moments, merge_moments, update_moments,
)
from repro_torch.core.selection import (  # noqa: F401
    greedy_select, rank_layers, select_layers,
)
from repro_torch.core.surgery import (  # noqa: F401
    compress, compress_config, compress_params, nbl_variant,
)
