"""Device resolution shared by the port's entry points.

Every entry point (``init_params``, ``Engine``, ``serve_requests``) takes
``device=`` and defaults to ``"cuda"``. A CUDA request with no CUDA device
present raises: nothing silently carries on on the CPU. The CPU is used
only when the caller asks for it, as the CPU tests do.
"""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(DTYPES)}")
