"""PyTorch/CUDA port of the NBL compression and serving system
(``repro`` is the JAX reference it is held against).

This package imports ``torch`` and never ``jax``, and nothing of the
``repro`` package: it keeps its own copy of what it needs. Only its tests
import both. Its module names follow ``repro``'s, so each counterpart is
found under the same path:

  configs/       Block / StackGroup / ModelConfig, tiny + Llama-3.1-8B
  core/          NBL compression: moments (K4), CCA bound, LMMSE maps,
                 calibrate, selection, surgery, DROP / SLEB, nbl_compress
  data/          the synthetic calibration / eval corpus
  eval/          perplexity and the successor probe
  models/        layers, attention, transformer (full-sequence forward,
                 calibration taps, prefill, decode, fused step), paging
  kernels/       hand-written CUDA kernels (csrc/) + their plain versions
  launch/        step planning, scheduler, the paged Engine, generate
  interop        JAX (cfg, params) as numpy -> port params (tests only)
"""
