from repro_torch.models.paging import init_paged_cache  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    fused_step, init_params, params_to,
)
