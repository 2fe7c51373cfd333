from repro_torch.models.paging import assign_pages, init_paged_cache  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    apply, decode_step, forward_with_taps, fused_step, init_params, loss_fn,
    params_to, prefill,
)
