"""Interop with the JAX package's data, for the parity tests.

The functions here take the JAX package's configs and pytrees AS PLAIN
PYTHON AND NUMPY (this module imports neither ``jax`` nor ``repro``):

  config_from_jax(jcfg)              a ``repro`` ModelConfig -> the port's
  from_jax_params(cfg, params_np)    JAX params (numpy leaves) -> port params
  cache_from_jax(cfg, cache_np)      JAX cache (numpy) -> port cache: the
                                     paged pools, or the monolithic /
                                     prefill ring {k, v, kpos}

Like every entry point of the port, the converters put their tensors on
``device="cuda"`` unless they are given another device.

JAX params are stacked per stack group: ``params["groups"][gi]["scanned"]
[u]`` has a leading ``repeat`` dim, and a shared block's single copy sits
in ``["shared"][u]`` (``repro/models/transformer.py``). The converter
unstacks them into the port's per-layer list, for any stack plan that
``repro.core.surgery.compress`` produces (several groups, periodic units).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import Block, ModelConfig, StackGroup
from repro_torch.device import resolve_device


def config_from_jax(jcfg) -> ModelConfig:
    """The port's ModelConfig for a ``repro.configs.base.ModelConfig``."""
    for name in ("moe", "ssm", "frontend"):
        if getattr(jcfg, name, None) is not None:
            raise NotImplementedError(
                f"{jcfg.name}: {name} is not in this slice of the port")
    stack = tuple(
        StackGroup(unit=tuple(Block(kind=b.kind, ffn=b.ffn, window=b.window,
                                    shared=b.shared) for b in g.unit),
                   repeat=g.repeat)
        for g in jcfg.stack)
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig) if f.name != "stack"}
    return ModelConfig(stack=stack, **kw)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: no torch view
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return None if x is None else fn(x)


def from_jax_params(cfg, params_np: dict, *, device="cuda") -> dict:
    """Port params from JAX params whose leaves are numpy arrays. ``cfg``
    is the JAX config or its port twin (only ``stack`` is read)."""
    dev = resolve_device(device)
    out = {k: _tensor(params_np[k], dev)
           for k in ("embed", "final_norm", "head") if k in params_np}
    layers = []
    for gi, g in enumerate(cfg.stack):
        gp = params_np["groups"][gi]
        shared: dict = {}
        for r in range(g.repeat):
            for u, blk in enumerate(g.unit):
                if blk.shared:
                    if u not in shared:
                        shared[u] = _tree(gp["shared"][u],
                                          lambda a: _tensor(a, dev))
                    layers.append(shared[u])
                else:
                    layers.append(_tree(gp["scanned"][u],
                                        lambda a, r=r: _tensor(a[r], dev)))
    out["layers"] = layers
    return out


def cache_from_jax(cfg, cache_np: dict, *, device="cuda") -> dict:
    """Port cache ``{"layers": [...]}`` from a JAX cache tree (numpy
    leaves): a paged cache (``repro.models.paging.init_paged_cache``
    layout) gives ``{"k_pages", "v_pages"}`` per attention layer, the cache
    ``prefill`` / ``decode_step`` carry gives ``{"k", "v", "kpos"}``. Each
    leaf is unstacked along its group's repeat dim."""
    dev = resolve_device(device)
    layers = []
    for gi, g in enumerate(cfg.stack):
        for r in range(g.repeat):
            for u, blk in enumerate(g.unit):
                c = cache_np["groups"][gi]["blocks"][u]
                if blk.kind == "attn":
                    keys = ("k_pages", "v_pages") if "k_pages" in c \
                        else ("k", "v", "kpos")
                    layers.append({k: _tensor(c[k][r], dev) for k in keys})
                else:
                    layers.append(None)
    return {"layers": layers}
