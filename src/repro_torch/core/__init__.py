"""NBL compression. This slice of the port carries the config half of the
surgery; calibration (moments, CCA, LMMSE, selection) comes later."""
from repro_torch.core.surgery import (  # noqa: F401
    compress_config, nbl_variant, transform_block,
)
