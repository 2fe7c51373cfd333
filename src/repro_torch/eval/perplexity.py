"""Perplexity + probe-task evaluation (paper §4 stand-in, offline).

Port of ``repro.eval.perplexity``: perplexity on the synthetic corpus
(``models.transformer.loss_fn``) plus a deterministic-successor probe
accuracy (the learnable structure of the Zipf–Markov stream), both over
the full-sequence forward (K3 in every attention layer). Like every entry
point they run on ``device="cuda"`` unless the caller asks for the CPU,
and raise if the params live elsewhere."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import params_device
from repro_torch.models.transformer import apply, loss_fn


def perplexity(cfg: ModelConfig, params: dict, data_factory: Callable, *,
               device="cuda") -> float:
    params_device(params, device)
    tot, n = 0.0, 0.0
    for batch in data_factory():
        _, m = loss_fn(cfg, params, batch)
        tot += float(m["ce"] * m["ntokens"])
        n += float(m["ntokens"])
    return math.exp(tot / max(n, 1.0))


def successor_accuracy(cfg: ModelConfig, params: dict,
                       data_factory: Callable, succ: np.ndarray, *,
                       device="cuda") -> float:
    """Fraction of positions where the model's argmax equals the Markov
    successor — a crisp 'did compression preserve the learned structure'
    probe (higher = better)."""
    dev = params_device(params, device)
    hit, n = 0, 0
    for batch in data_factory():
        logits, _ = apply(cfg, params, torch.as_tensor(batch["tokens"],
                                                       device=dev))
        pred = logits.argmax(dim=-1).cpu().numpy()
        want = succ[batch["tokens"]]
        hit += int((pred[:, :-1] == want[:, :-1]).sum())
        n += pred[:, :-1].size
    return hit / max(n, 1)


def eval_suite(cfg: ModelConfig, params: dict, data_factory: Callable,
               succ: np.ndarray | None = None, *, device="cuda") -> dict:
    out = {"ppl": perplexity(cfg, params, data_factory, device=device)}
    if succ is not None:
        out["succ_acc"] = successor_accuracy(cfg, params, data_factory, succ,
                                             device=device)
    return out
