"""PyTorch/CUDA port of the NBL serving system (``repro`` is the JAX
reference it is held against).

This package imports ``torch`` and never ``jax``, and nothing of the
``repro`` package: it keeps its own copy of what it needs. Only its tests
import both. Its module names follow ``repro``'s, so each counterpart is
found under the same path:

  configs/       Block / StackGroup / ModelConfig, tiny + Llama-3.1-8B
  core/surgery   NBL config rewriting (compress_config, nbl_variant)
  models/        layers, paged attention, transformer fused step, paging
  kernels/       hand-written CUDA kernels (csrc/) + their plain versions
  launch/        step planning, scheduler, the paged chunked Engine
  interop        JAX (cfg, params) as numpy -> port params (tests only)
"""
