"""Arch config registry. Importing this package registers all configs."""
from repro_torch.configs.base import (  # noqa: F401
    Block, ModelConfig, StackGroup, dense_stack, get_config, register,
)
from repro_torch.configs import llama31_8b, tiny  # noqa: F401
