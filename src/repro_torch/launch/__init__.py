from repro_torch.launch.engine import Engine  # noqa: F401
from repro_torch.launch.scheduler import (  # noqa: F401
    Request, Scheduler, nbl_page_budget,
)
from repro_torch.launch.serve import generate, serve_requests  # noqa: F401
