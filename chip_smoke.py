#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases build,k1,k2,k3,k4   # a short kernel check

Phases, in order (each passes or raises; any failure exits non-zero):

  card     the card's name and power limit
  build    nvcc builds K1, K2, K3 and K4 from csrc/ into build/ (in
           parallel)
  k1       K1 (paged attention, mixed rows) against its plain version at
           Llama-3.1-8B shapes (KV=8, rep=4, hd=128, page_size=64), bf16
           and float32, with window=32/softcap=50 in one case
  k2       K2 (NBL linear) against its plain version at d=4096,
           M in {8, 512, 1000}, with and without residual, bf16 and float32
  k3       K3 (flash attention over positions) against its plain version
           at Llama shapes (H=32, KV=8, hd=128; S in {128, 512, 2048},
           a bucketed prompt, a partial prefill with T = 1024 + 512, one
           case with window=32/softcap=50) and at hd 16/32/64/256, rep
           1/2/8, ragged S, T != S, non-causal; bf16 and float32
  k4       K4 (covariance accumulation acc += y^T x) against its plain
           version: T in {1, 1000, 4096} x (Dy, Dx) in {(4096, 4096),
           (512, 256), (256, 512), (4096, 1000)}, the Gram update
           (y=None), ragged widths; float32 and bf16 inputs, a non-zero
           acc, a two-call running sum, bit-equal repeat runs
  tiny     tiny-dense and NBL-2 tiny-dense served on the CPU and on the GPU
           from the same weights: the greedy tokens must be equal
  llama    Llama-3.1-8B at full width (random weights from a seed, bf16)
           with 12 NBL layers served through Engine(paged, chunked, fused)
           on 8 requests; asserts finite logits and K1/K2 launch counts;
           then the same weights dense (m=0), printed beside it
  admit    the same NBL-12 model and requests through
           Engine(chunked_prefill=False), after one unmeasured warm-up
           pass: one whole-prompt prefill per admission (K3 in every
           attention layer, K2 in every NBL layer), then fused decode
           steps (K1, K2); asserts finite logits and
           K3 = 20 x admissions, K1 = 20 x steps, K2 = 12 x (admissions +
           steps); prints tok/s, median step, each admission's time
  generate greedy tokens of generate(), Engine(chunked_prefill=False) and
           Engine(chunked_prefill=True) equal on CPU and GPU for tiny-dense
           and NBL-2 tiny-dense; Llama NBL-12 at B=4, S=512: generate's
           prefill logits against each Engine admission's (bf16
           tolerance), token agreement printed
  compress tiny-dense nbl_compress(m=2) on the CPU and on the GPU from the
           same weights (same layers, bounds within 1e-5 relative, W within
           1e-4, equal greedy tokens of the compressed model); then
           Llama-3.1-8B (the llama phase's dense weights) compressed by
           nbl_compress(m=12) over all 32 attention layers on 4 x 4 x 1024
           calibration tokens (K3 in the tapped forwards, K4 in every
           moment update; launch counts asserted), Theorem 3.2 checked per
           layer, and the NBL-12 model it chose served through
           Engine(paged, chunked) on the llama phase's 8 requests (K1, K2
           counts asserted); prints the chosen layers, every bound, the
           seconds of forward / moments / CCA+LMMSE and tokens/s
  table    each kernel's time at the llama phase's decode and 512-token
           chunk shapes (K1, K2), at the admission shapes S=512 and
           S=2048 (K3) and at one moment update of the compress phase
           (K4), beside its plain version, its bound and a library
           yardstick the port never calls
  profile  (only when named) the llama phase's NBL-12 run once more, and
           the admit phase's 8 admissions alone, under torch.profiler:
           device time by kernel family, the device's idle share of the
           wall time

The next-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("card", "build", "k1", "k2", "k3", "k4", "tiny", "llama", "admit",
          "generate", "compress", "table")
EXTRA_PHASES = ("profile",)         # run only when named in --phases

# H100 SXM data-sheet peaks (dense): bytes/s of HBM3 and ops/s per type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

# tolerances, kernel vs plain version on the same inputs (valid rows only)
K1_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}    # atol = rtol
K2_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# K3 bf16: the kernel rounds the probability tile to bf16 for the PV
# product (the plain version keeps it float32) and rounds the output once
K3_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
# K4: float32 sums over T; both versions round each partial sum, in
# another order, so the bound scales with sum_t |y||x| (plus |acc_in|)
K4_TOL = 1e-5
# Llama logits, generate's batch-4 prefill vs an engine admission at batch
# 1: the same kernels on the same rows, but cuBLAS tiles batch-4 and
# batch-1 GEMMs differently, and 32 bf16 layers (8-bit mantissa, one ulp
# ~ 0.4 %) compound the rounding differences
LOGIT_TOL_BF16 = 0.1                # atol = rtol
NBL_LAYERS = tuple(range(20, 32))   # paper m=12: the deepest 12 attention layers
# compress phase: Llama calibration stream, 4 x 1024 tokens a batch; more
# tokens than d = 4096 (with fewer, C_XX is singular and every canonical
# correlation is 1)
CALIB = dict(batch=4, seq=1024, n_batches=4)
# tiny-dense NBL-2 compressed on the CPU and on the GPU: float32 moments
# summed in another order, so bounds and maps agree to float32 rounding
TINY_BOUND_RTOL = 1e-5
TINY_W_ATOL = 1e-4


def log(*a):
    print(*a, flush=True)


def _dtname(dt) -> str:
    return str(dt).replace("torch.", "")


def _time_ms(fn, args_list, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn(*args)`` over ``iters`` back-to-back calls timed
    with CUDA events, cycling through ``args_list`` so each call finds its
    inputs cold in L2 the way the serving step does (one layer's tensors
    per call)."""
    import torch
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ------------------------------------------------------------------ K1 ----

def _k1_case(torch, gen, dev, dtype, *, b, w, row_len, row_pos, n_pages=400,
             kv=8, rep=4, hd=128, ps=64, n_lp=40, holes=()):
    """Random pools and a random page table for the given rows."""
    q = torch.randn((b, kv, rep, w, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_pages, kv, ps, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n_pages, kv, ps, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev)[:b * n_lp]
    tbl = perm.reshape(b, n_lp).to(torch.int32)
    for bi in range(b):                       # unallocated past each row
        need = -(-(row_pos[bi] + max(row_len[bi], 1)) // ps)
        tbl[bi, need:] = -1
    for bi, lp in holes:                      # released (window) pages
        tbl[bi, lp] = -1
    rp = torch.tensor(row_pos, dtype=torch.int32, device=dev)
    rl = torch.tensor(row_len, dtype=torch.int32, device=dev)
    return q, kp, vp, tbl.contiguous(), rp, rl


def _k1_valid_mask(torch, row_len, w, shape):
    b, kv, rep, _, hd = shape
    m = torch.zeros(shape, dtype=torch.bool)
    for bi, n in enumerate(row_len):
        m[bi, :, :, :min(n, w)] = True
    return m


def _k1_check(torch, gen, dev, dtype, c, label):
    """K1 against its plain version on one case; returns max |err|."""
    from repro_torch.kernels.paged_attention import paged_mixed, paged_mixed_ref
    geo = {k: c[k] for k in ("kv", "rep", "hd", "ps", "n_lp", "n_pages")
           if k in c}
    q, kp, vp, tbl, rp, rl = _k1_case(
        torch, gen, dev, dtype, b=len(c["row_len"]), w=c["w"],
        row_len=c["row_len"], row_pos=c["row_pos"], holes=c.get("holes", ()),
        **geo)
    kw = dict(window=c.get("window"), softcap=c.get("softcap"))
    out = paged_mixed(q, kp, vp, tbl, rp, rl, **kw)
    ref = paged_mixed_ref(q, kp, vp, tbl, rp, rl, **kw)
    torch.cuda.synchronize()
    tol = K1_TOL[_dtname(dtype)]
    mask = _k1_valid_mask(torch, c["row_len"], c["w"], q.shape).to(dev)
    o, r = out.float()[mask], ref.float()[mask]
    err = (o - r).abs().max().item()
    bad = ((o - r).abs() > tol + tol * r.abs()).sum().item()
    inv = out.float()[~mask]
    log(f"  k1 {_dtname(dtype):8s} {label}: max|err| valid rows {err:.3e} "
        f"(atol=rtol={tol}), invalid rows zero: {bool((inv == 0).all())}")
    if bad or not torch.isfinite(out).all() or not (inv == 0).all():
        raise AssertionError(f"K1 disagrees with its plain version: {bad} "
                             f"elements out of tolerance")
    return err


def phase_k1(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    # Llama shapes: decode rows (len 1), chunk rows (64 / 256), a short
    # row, inactive rows; then the other supported head dims and page sizes
    llama = [
        dict(w=256, row_len=[1, 64, 256, 0, 37, 1, 256, 0],
             row_pos=[1500, 640, 1792, 0, 128, 63, 0, 0]),
        dict(w=64, row_len=[64, 1, 0, 64, 13, 1, 64, 1],
             row_pos=[0, 2047, 0, 1024, 320, 5, 1984, 700]),
        dict(w=1, row_len=[1, 1, 1, 0, 1, 1, 1, 1],
             row_pos=[0, 63, 64, 0, 2047, 1000, 1500, 7]),
    ]
    llama.append(dict(llama[0], window=32, softcap=50.0, holes=[(0, 3)]))
    geometry = [
        dict(hd=16, ps=8, kv=2, rep=2, n_lp=8, n_pages=30, w=8,
             row_len=[8, 1, 0], row_pos=[0, 37, 0]),
        dict(hd=64, ps=16, kv=4, rep=1, n_lp=8, n_pages=30, w=4,
             row_len=[4, 1, 3], row_pos=[16, 90, 5]),
        dict(hd=256, ps=128, kv=2, rep=8, n_lp=4, n_pages=16, w=16,
             row_len=[16, 1, 9], row_pos=[200, 511, 0]),
        dict(hd=128, ps=8, kv=2, rep=4, n_lp=16, n_pages=60, w=32,
             row_len=[32, 1, 20], row_pos=[40, 100, 7], window=12,
             softcap=20.0),
    ]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for ci, c in enumerate(llama):
            extra = " window=32 softcap=50" if "window" in c else ""
            worst = max(worst, _k1_check(
                torch, gen, dev, dtype, c,
                f"llama case {ci} W={c['w']}{extra}"))
        for c in geometry:
            worst = max(worst, _k1_check(
                torch, gen, dev, dtype, c,
                f"hd={c['hd']} page_size={c['ps']} rep={c['rep']} "
                f"W={c['w']}{' window/softcap' if 'window' in c else ''}"))
    return worst


# ------------------------------------------------------------------ K2 ----

def _k2_check(torch, gen, dev, dtype, m, k, n, res):
    from repro_torch.kernels.nbl_linear import nbl_linear, nbl_linear_ref
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dtype)
    b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(dtype)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    y = nbl_linear(x, w, b, residual=res)
    r = nbl_linear_ref(x, w, b, residual=res)
    torch.cuda.synchronize()
    tol = K2_TOL[_dtname(dtype)]
    diff = (y.float() - r.float()).abs()
    err = diff.max().item()
    bad = (diff > tol + tol * r.float().abs()).sum().item()
    log(f"  k2 {_dtname(dtype):8s} M={m:4d} K={k:4d} N={n:4d} "
        f"residual={res!s:5s} max|err| {err:.3e} (atol=rtol={tol})")
    if bad or not torch.isfinite(y).all():
        raise AssertionError(f"K2 disagrees with its plain version: {bad} "
                             f"elements out of tolerance")
    return err


def phase_k2(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    d = 4096
    # d_model-wide cases of the main path, then ragged M / N / K (K % 8 != 0
    # takes the element-wise tile loads)
    cases = [(m, d, d, res) for m in (8, 512, 1000) for res in (True, False)]
    cases += [(37, 100, 72, False), (5, 96, 96, True), (33, 200, 200, True)]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for m, k, n, res in cases:
            worst = max(worst, _k2_check(torch, gen, dev, dtype, m, k, n, res))
    return worst


# ------------------------------------------------------------------ K3 ----

def _causal(s):
    import numpy as np
    pos = np.arange(s, dtype=np.int32)
    return pos, pos


def _bucket(s, valid):
    """A prompt of ``valid`` tokens right-padded to ``s`` (admission)."""
    import numpy as np
    pos = np.arange(s, dtype=np.int32)
    return pos, np.where(pos < valid, pos, -1).astype(np.int32)


def _prefix(pages, ps, prefix_len, s):
    """A partial prefill: suffix queries at prefix_len + i over [prefix
    pages gathered through the table (-1 past prefix_len) ++ suffix]."""
    import numpy as np
    qpos = (prefix_len + np.arange(s)).astype(np.int32)
    t = np.arange(pages * ps)
    return qpos, np.concatenate(
        [np.where(t < prefix_len, t, -1).astype(np.int32), qpos])


def _k3_inputs(torch, gen, dev, dtype, c):
    b, h, kv, hd = c.get("b", 1), c.get("h", 32), c.get("kv", 8), \
        c.get("hd", 128)
    qpos, kpos = c["pos"]
    q = torch.randn((b, h, len(qpos), hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kv, len(kpos), hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kv, len(kpos), hd), generator=gen, device=dev).to(dtype)
    return (q, k, v, torch.from_numpy(qpos).to(dev),
            torch.from_numpy(kpos).to(dev))


def _k3_check(torch, gen, dev, dtype, c, label):
    """K3 against its plain version on one case; returns max |err| over
    the rows with an attended key (the others must be zero)."""
    from repro_torch.kernels.flash_attention import (
        attend_mask, flash_attention, flash_attention_ref)
    args = _k3_inputs(torch, gen, dev, dtype, c)
    kw = dict(causal=c.get("causal", True), window=c.get("window"),
              softcap=c.get("softcap"))
    out = flash_attention(*args, **kw)
    ref = flash_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    rows = attend_mask(args[3], args[4], causal=kw["causal"],
                       window=kw["window"]).any(dim=1)
    tol = K3_TOL[_dtname(dtype)]
    o, r = out.float()[:, :, rows], ref.float()[:, :, rows]
    err = (o - r).abs().max().item()
    bad = ((o - r).abs() > tol + tol * r.abs()).sum().item()
    dead = out.float()[:, :, ~rows]
    log(f"  k3 {_dtname(dtype):8s} {label}: max|err| {err:.3e} "
        f"(atol=rtol={tol}); rows without a key zero: "
        f"{bool((dead == 0).all())} ({int((~rows).sum())} rows)")
    if bad or not torch.isfinite(out).all() or not (dead == 0).all():
        raise AssertionError(f"K3 disagrees with its plain version: {bad} "
                             f"elements out of tolerance")
    return err


def _k3_cases():
    """(label, case) lists: Llama-3.1-8B shapes, then other geometries."""
    llama = [
        ("S=128 causal", dict(pos=_causal(128))),
        ("S=512 causal", dict(pos=_causal(512))),
        ("S=2048 causal", dict(pos=_causal(2048))),
        ("B=4 S=1024 causal (calibration forward)",
         dict(b=4, pos=_causal(1024))),
        ("S=2048 bucket of a 1499-token prompt",
         dict(pos=_bucket(2048, 1499))),
        ("partial prefill S=512 over 16 prefix pages (T=1024+512, prefix "
         "960)", dict(pos=_prefix(16, 64, 960, 512))),
        ("S=512 window=32 softcap=50",
         dict(pos=_causal(512), window=32, softcap=50.0)),
    ]
    geometry = [
        ("hd=16 rep=2 B=2 S=40 (tiny-dense)",
         dict(b=2, h=4, kv=2, hd=16, pos=_causal(40))),
        ("hd=32 rep=1 S=100 window=16",
         dict(h=8, kv=8, hd=32, pos=_causal(100), window=16)),
        ("hd=64 rep=2 S=77 T=141 partial prefill",
         dict(h=16, kv=8, hd=64, pos=_prefix(4, 16, 48, 77))),
        ("hd=256 rep=8 S=130 softcap=30",
         dict(h=16, kv=2, hd=256, pos=_causal(130), softcap=30.0)),
        ("hd=64 rep=2 S=64 bucket of 20 window=8 (rows 28.. see no key)",
         dict(h=4, kv=2, hd=64, pos=_bucket(64, 20), window=8)),
        ("hd=128 rep=4 S=33 T=50 non-causal, padded keys",
         dict(h=8, kv=2, hd=128, causal=False,
              pos=(_causal(33)[0], _bucket(50, 41)[1]))),
    ]
    return llama, geometry


def phase_k3(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    llama, geometry = _k3_cases()
    for dtype in (torch.bfloat16, torch.float32):
        for label, c in llama + geometry:
            geo = "" if "hd" in c else "Llama H=32 KV=8 hd=128 "
            worst = max(worst, _k3_check(torch, gen, dev, dtype, c,
                                         geo + label))
    return worst


# ------------------------------------------------------------------ K4 ----

def _k4_check(torch, gen, dev, dtype, t, dy, dx, gram, label):
    """K4 against its plain version on one case, from a non-zero acc and
    as a running sum over two calls; two runs must be bit-equal. Returns
    max |err|."""
    from repro_torch.kernels.cov_accum import cov_accum, cov_accum_ref
    x = torch.randn((t, dx), generator=gen, device=dev).to(dtype)
    y = None if gram else torch.randn((t, dy), generator=gen,
                                      device=dev).to(dtype)
    acc0 = torch.randn((dx if gram else dy, dx), generator=gen, device=dev)
    yy = x if gram else y
    ref = cov_accum_ref(acc0, x, y)
    # per entry: K4_TOL * (sum_t |y||x| + |acc_in|), the float32 rounding
    # of a sum of that magnitude, in either summation order
    scale = yy.float().abs().t() @ x.float().abs() + acc0.abs()
    runs = []
    for _ in range(2):
        a = acc0.clone()
        if cov_accum(a, x, y) is not a:
            raise AssertionError("K4 did not update acc in place")
        runs.append(a)
    half = t // 2
    two = acc0.clone()                          # running sum over two calls
    if half:
        cov_accum(two, x[:half].contiguous(),
                  None if gram else y[:half].contiguous())
    cov_accum(two, x[half:].contiguous(),
              None if gram else y[half:].contiguous())
    torch.cuda.synchronize()
    err = max((r - ref).abs().max().item() for r in (runs[0], two))
    bad = sum(((r - ref).abs() > K4_TOL * scale).sum().item()
              for r in (runs[0], two))
    same = torch.equal(runs[0], runs[1])
    log(f"  k4 {_dtname(dtype):8s} {label}: max|err| {err:.3e} "
        f"(one call and two-call running sum; atol {K4_TOL} x "
        f"(sum_t |y||x| + |acc|) per entry); repeat bit-equal: {same}")
    if bad or not same or not torch.isfinite(runs[0]).all():
        raise AssertionError(f"K4 disagrees with its plain version ({bad} "
                             f"elements out of tolerance) or is not "
                             f"deterministic (bit-equal repeat: {same})")
    return err


def phase_k4(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for t in (1, 1000, 4096):
            for dy, dx in ((4096, 4096), (512, 256), (256, 512), (4096, 1000)):
                worst = max(worst, _k4_check(
                    torch, gen, dev, dtype, t, dy, dx, False,
                    f"T={t:4d} Dy={dy:4d} Dx={dx:4d}"))
            for dx in (4096, 1000):
                worst = max(worst, _k4_check(
                    torch, gen, dev, dtype, t, dx, dx, True,
                    f"T={t:4d} Gram (y=None) D={dx:4d}"))
        # widths that are not multiples of 4 take the element-wise loads
        worst = max(worst, _k4_check(torch, gen, dev, dtype, 333, 70, 130,
                                     False, "T= 333 Dy=  70 Dx= 130"))
    return worst


# ---------------------------------------------------------------- tiny ----

def phase_tiny(torch, dev):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.surgery import nbl_variant
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.transformer import init_params, params_to
    rng = np.random.default_rng(5)
    lens = (3, 8, 17, 24, 33, 40)
    for m in (0, 2):
        cfg = nbl_variant(get_config("tiny-dense"), m)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        p_cpu = init_params(cfg, seed=3, device="cpu")
        kw = dict(max_new=8, page_size=8, step_tokens=16)
        cpu, _ = serve_requests(cfg, p_cpu, prompts, device="cpu", **kw)
        gpu, st = serve_requests(cfg, params_to(p_cpu, dev), prompts,
                                 device=dev, **kw)
        same = all(np.array_equal(a, g) for a, g in zip(cpu, gpu))
        log(f"  tiny-dense NBL-{m}: {len(prompts)} prompts (lengths "
            f"{list(lens)}), {st['n_fused_dispatches']} fused steps, "
            f"tokens equal CPU vs GPU: {same}")
        if not same:
            raise AssertionError(f"NBL-{m} tokens differ: cpu={cpu} gpu={gpu}")


# --------------------------------------------------------------- llama ----

def _nbl_params(torch, cfg, params, layer_ids, gen, dev):
    """NBL-m params sharing every tensor of the dense ones except the
    linearized layers' attention, which becomes a random (W, b) map."""
    from repro_torch.models.transformer import init_nbl_linear
    layers = list(params["layers"])
    for i in layer_ids:
        dense = layers[i]
        layers[i] = {"mixer": init_nbl_linear(cfg, gen, dev),
                     "norm2": dense["norm2"], "ffn": dense["ffn"]}
    return dict(params, layers=layers)


def _serve_llama(torch, cfg, params, prompts, dev, record=None,
                 chunked=True):
    """Serve the prompts through the paged fused engine, chunked or with
    whole-prompt admission, checking every emitting row's logits (the
    admission prefill's included) for finiteness and timing each
    admission. Returns a summary dict."""
    from repro_torch.launch.engine import Engine
    admissions: list = []

    class CheckedEngine(Engine):
        def _admit(self, req, slot):
            t0 = time.perf_counter()
            super()._admit(req, slot)  # whole-prompt: ends in a readback
            admissions.append((len(req.prompt), time.perf_counter() - t0))

        def _run_partial_prefill(self, slot, req, start, end):
            logits = super()._run_partial_prefill(slot, req, start, end)
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite admission logits")
            return logits

        def _execute_fused(self, plan):
            if record is not None:
                toks, rp, rl = self._fused_inputs(plan)
                record.append(dict(width=plan.width, row_pos=rp, row_len=rl,
                                   tbl=self.page_tbl.copy(),
                                   n_decode=len(plan.decode_slots)))
            return super()._execute_fused(plan)

        def _commit_fused(self, plan, logits):
            live = plan.decode_slots + [c.slot for c in plan.chunk_rows
                                        if c.final]
            if live and not torch.isfinite(logits[live, -1]).all():
                raise AssertionError("non-finite logits on an emitting row")
            return super()._commit_fused(plan, logits)

    max_new = 64
    kw = dict(prefill_chunk_tokens=512) if chunked else {}
    eng = CheckedEngine(cfg, params, max_len=max(map(len, prompts)) + max_new,
                        n_slots=8, page_size=64, step_tokens=512,
                        chunked_prefill=chunked, device=dev, **kw)
    rids = [eng.submit(p, max_new, strict=True) for p in prompts]
    torch.cuda.synchronize()
    steps = []
    t_start = time.perf_counter()
    while eng.has_work:
        t0 = time.perf_counter()
        eng.step()                 # ends in the logits readback (a sync)
        steps.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_start
    n_tok = sum(len(eng.finished[r].tokens) for r in rids)
    if any(len(eng.finished[r].tokens) != max_new for r in rids):
        raise AssertionError("a request did not finish its max_new tokens")
    return dict(engine=eng, wall_s=wall, tokens=n_tok, steps=steps,
                dispatches=eng.n_fused_dispatches, prefills=eng.n_prefills,
                admissions=admissions, tok_s=n_tok / wall,
                median_step_ms=1e3 * statistics.median(steps))


def _llama_model(torch, dev, ctx):
    """Llama-3.1-8B at full width (random bf16 weights, seed 0), its NBL-12
    variant sharing every other tensor, and the 8 prompts; built once."""
    if "model" in ctx:
        return ctx["model"]
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.surgery import compress_config
    from repro_torch.models.transformer import init_params

    cfg = get_config("llama-3.1-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    ncfg = compress_config(cfg, NBL_LAYERS, "nbl")
    nparams = _nbl_params(torch, cfg, params, NBL_LAYERS, gen, dev)
    torch.cuda.synchronize()
    log(f"  llama-3.1-8b: 32 layers, d=4096, GQA 32/8, d_ff=14336, vocab "
        f"128256, bf16, random weights (seed 0) built in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  NBL layers (m={len(NBL_LAYERS)}): {list(NBL_LAYERS)}; attention "
        f"layers left: {sum(1 for b in ncfg.blocks() if b.kind == 'attn')}")
    rng = np.random.default_rng(0)
    lens = np.linspace(128, 2048, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    ctx["model"] = (cfg, params, ncfg, nparams, prompts)
    return ctx["model"]


def _kinds(cfg):
    return (sum(1 for b in cfg.blocks() if b.kind == "attn"),
            sum(1 for b in cfg.blocks() if b.kind == "nbl"))


def phase_llama(torch, dev, ctx):
    from repro_torch.kernels import K1, K2

    cfg, params, ncfg, nparams, prompts = _llama_model(torch, dev, ctx)
    n_attn, n_nbl = _kinds(ncfg)
    log(f"  8 requests, prompt lengths {[len(p) for p in prompts]}, max_new "
        f"64; Engine(paged, chunked, page_size=64, n_slots=8, "
        f"step_tokens=512, prefill_chunk_tokens=512)")

    record: list = []
    K1.reset()
    K2.reset()
    nbl = _serve_llama(torch, ncfg, nparams, prompts, dev, record)
    k1_n, k2_n = K1.launches, K2.launches
    disp = nbl["dispatches"]
    log(f"  NBL-12: {nbl['tokens']} tokens in {nbl['wall_s']:.3f} s -> "
        f"{nbl['tok_s']:.1f} generated tok/s; {disp} fused steps, median "
        f"step {nbl['median_step_ms']:.2f} ms; K1 launches {k1_n} "
        f"(= {n_attn} x {disp}: {k1_n == n_attn * disp}), K2 launches "
        f"{k2_n} (= {n_nbl} x {disp}: {k2_n == n_nbl * disp})")
    if k1_n != n_attn * disp or k2_n != n_nbl * disp or disp == 0:
        raise AssertionError("the main path did not run every fused step "
                             "through K1 and K2")
    dense = _serve_llama(torch, cfg, params, prompts, dev)
    log(f"  dense (m=0, same weights): {dense['tokens']} tokens in "
        f"{dense['wall_s']:.3f} s -> {dense['tok_s']:.1f} generated tok/s; "
        f"{dense['dispatches']} fused steps, median step "
        f"{dense['median_step_ms']:.2f} ms (printed, not claimed)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB")
    ctx.update(cfg=ncfg, params=nparams, engine=nbl["engine"], record=record,
               k1_launches=k1_n, k2_launches=k2_n, prompts=prompts,
               wall_s=nbl["wall_s"])


# --------------------------------------------------------------- admit ----

def phase_admit(torch, dev, ctx):
    from repro_torch.kernels import K1, K2, K3

    _, _, ncfg, nparams, prompts = _llama_model(torch, dev, ctx)
    n_attn, n_nbl = _kinds(ncfg)
    log(f"  NBL-12, the same 8 requests (prompt lengths "
        f"{[len(p) for p in prompts]}), max_new 64; "
        f"Engine(paged, chunked_prefill=False, bucket_prompts=True, "
        f"page_size=64, n_slots=8, step_tokens=512)")
    # a first pass loads the GEMM and elementwise kernels of the prefill's
    # new shapes (lazy module loading); the measured pass follows it
    warm = _serve_llama(torch, ncfg, nparams, prompts, dev, chunked=False)
    log(f"  warm-up pass: {warm['wall_s']:.3f} s, admissions (ms) "
        f"{[round(1e3 * t, 2) for _, t in warm['admissions']]}")
    for c in (K1, K2, K3):
        c.reset()
    run = _serve_llama(torch, ncfg, nparams, prompts, dev, chunked=False)
    k1_n, k2_n, k3_n = K1.launches, K2.launches, K3.launches
    disp, adm = run["dispatches"], run["prefills"]
    want = (n_attn * disp, n_nbl * (adm + disp), n_attn * adm)
    log(f"  {run['tokens']} tokens in {run['wall_s']:.3f} s -> "
        f"{run['tok_s']:.1f} generated tok/s; {adm} admission prefills, "
        f"{disp} fused steps, median step {run['median_step_ms']:.2f} ms")
    log(f"  launches: K3 {k3_n} (= {n_attn} x {adm} admissions: "
        f"{k3_n == want[2]}), K1 {k1_n} (= {n_attn} x {disp} steps: "
        f"{k1_n == want[0]}), K2 {k2_n} (= {n_nbl} x ({adm} + {disp}): "
        f"{k2_n == want[1]})")
    for plen, sec in run["admissions"]:
        log(f"    admission of a {plen:4d}-token prompt (bucket "
            f"{1 << (plen - 1).bit_length():4d}): {1e3 * sec:8.2f} ms "
            f"(prefill, page assignment, first-token readback)")
    if (k1_n, k2_n, k3_n) != want or adm != len(prompts) or disp == 0:
        raise AssertionError("the admission path did not run every prefill "
                             "through K3 and K2 and every step through K1 "
                             "and K2")
    ctx.update(k3_launches=k3_n, admit=run)


# ------------------------------------------------------------ generate ----

def _engine_tokens(cfg, params, prompts, dev, *, chunked, max_new):
    from repro_torch.launch.engine import Engine
    eng = Engine(cfg, params, max_len=max(map(len, prompts)) + max_new,
                 n_slots=4, page_size=8, step_tokens=16,
                 chunked_prefill=chunked, device=dev)
    rids = [eng.submit(p, max_new, strict=True) for p in prompts]
    out = eng.run()
    return [out[r].tolist() for r in rids]


def phase_generate(torch, dev, ctx):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.surgery import nbl_variant
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import init_params, params_to, prefill

    rng = np.random.default_rng(6)
    lens = (3, 8, 17, 24, 33, 40)
    for m in (0, 2):
        cfg = nbl_variant(get_config("tiny-dense"), m)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        p_cpu = init_params(cfg, seed=4, device="cpu")
        runs = {}
        for where, params in (("cpu", p_cpu), ("gpu", params_to(p_cpu, dev))):
            d = params["embed"].device
            runs[f"generate/{where}"] = [
                generate(cfg, params, p[None], max_new=8)[0].tolist()
                for p in prompts]
            for chunked in (False, True):
                runs[f"engine(chunked={chunked})/{where}"] = _engine_tokens(
                    cfg, params, prompts, d, chunked=chunked, max_new=8)
        ref = runs["generate/cpu"]
        same = {k: v == ref for k, v in runs.items()}
        log(f"  tiny-dense NBL-{m}: {len(prompts)} prompts (lengths "
            f"{list(lens)}), max_new 8; tokens equal to generate on the CPU: "
            + ", ".join(f"{k} {v}" for k, v in same.items()))
        if not all(same.values()):
            raise AssertionError(f"NBL-{m}: tokens differ: {runs}")

    _, _, ncfg, nparams, _ = _llama_model(torch, dev, ctx)
    b, s, max_new = 4, 512, 16
    tokens = torch.from_numpy(
        rng.integers(0, ncfg.vocab_size, (b, s))).to(dev)
    gen_logits, _ = prefill(ncfg, nparams, tokens, cache_len=s + max_new)
    gen_tokens = generate(ncfg, nparams, tokens, max_new=max_new).cpu()
    admitted = {}

    class Recording(Engine):
        def _run_partial_prefill(self, slot, req, start, end):
            logits = super()._run_partial_prefill(slot, req, start, end)
            admitted[req.rid] = logits[0, -1].float()
            return logits

    eng = Recording(ncfg, nparams, max_len=s + max_new, n_slots=b,
                    page_size=64, chunked_prefill=False, device=dev)
    rids = [eng.submit(t.cpu().numpy(), max_new, strict=True) for t in tokens]
    out = eng.run()
    g = gen_logits[:, -1].float()
    a = torch.stack([admitted[r] for r in rids])
    err = (g - a).abs().max().item()
    bad = ((g - a).abs() > LOGIT_TOL_BF16 * (1 + a.abs())).sum().item()
    first = (g.argmax(-1) == a.argmax(-1)).tolist()
    agree = [int((gen_tokens[i] == torch.from_numpy(out[r])).sum())
             for i, r in enumerate(rids)]
    log(f"  llama NBL-12, B={b} S={s} max_new={max_new}: generate's prefill "
        f"logits vs each engine admission's, max|diff| {err:.3e} (|logits| "
        f"up to {g.abs().max().item():.2f}; atol=rtol={LOGIT_TOL_BF16}); "
        f"first tokens equal {first}; tokens equal per request (of "
        f"{max_new}, printed, not asserted): {agree}")
    if bad or not torch.isfinite(g).all():
        raise AssertionError("generate and the engine admission disagree "
                             "on the first-token logits")


# ------------------------------------------------------------ compress ----

def _compress_tiny(torch, dev):
    """tiny-dense NBL-2 compressed on the CPU and on the GPU from the same
    weights: same layers, bounds and maps; then the same greedy tokens."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import nbl_compress
    from repro_torch.data import calib_factory
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.transformer import init_params, params_to

    cfg = get_config("tiny-dense")
    p_cpu = init_params(cfg, seed=3, device="cpu")
    fac = calib_factory(cfg)
    c_cfg, c_cpu, r_cpu = nbl_compress(cfg, p_cpu, fac, 2, device="cpu")
    g_cfg, c_gpu, r_gpu = nbl_compress(cfg, params_to(p_cpu, dev), fac, 2,
                                       device=dev)
    b_err = max(abs(r_gpu.bounds[i] - r_cpu.bounds[i]) / r_cpu.bounds[i]
                for i in r_cpu.bounds)
    w_err = max((c_gpu["layers"][i]["mixer"][n].cpu()
                 - c_cpu["layers"][i]["mixer"][n]).abs().max().item()
                for i in r_cpu.layers for n in ("w", "b"))
    w_max = max(c_cpu["layers"][i]["mixer"]["w"].abs().max().item()
                for i in r_cpu.layers)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 8, 17, 24, 33)]
    kw = dict(max_new=8, page_size=8, step_tokens=16)
    cpu, _ = serve_requests(c_cfg, c_cpu, prompts, device="cpu", **kw)
    gpu, _ = serve_requests(g_cfg, c_gpu, prompts, device=dev, **kw)
    same = all(np.array_equal(a, g) for a, g in zip(cpu, gpu))
    log(f"  tiny-dense nbl_compress(m=2), CPU vs GPU: layers "
        f"{r_cpu.layers} / {r_gpu.layers}; bounds max rel diff {b_err:.2e} "
        f"(limit {TINY_BOUND_RTOL}); W, b max |diff| {w_err:.2e} (max |W| "
        f"{w_max:.3f}, limit {TINY_W_ATOL}); greedy tokens of the "
        f"compressed model equal CPU vs GPU: {same}")
    if (r_cpu.layers != r_gpu.layers or b_err > TINY_BOUND_RTOL
            or w_err > TINY_W_ATOL or not same):
        raise AssertionError("tiny-dense compression differs between the "
                             "CPU and the GPU")


def phase_compress(torch, dev, ctx):
    import math
    from repro_torch.core import nbl_compress
    from repro_torch.data import calib_factory
    from repro_torch.kernels import K1, K2, K3, K4

    _compress_tiny(torch, dev)

    cfg, params, _, _, prompts = _llama_model(torch, dev, ctx)
    d, n_attn = cfg.d_model, len(cfg.attn_layer_indices())
    fac = calib_factory(cfg, **CALIB)
    n_tok = CALIB["batch"] * CALIB["seq"] * CALIB["n_batches"]
    log(f"  llama-3.1-8b (the dense weights of the llama phase): "
        f"nbl_compress(m={len(NBL_LAYERS)}) over all {n_attn} attention "
        f"layers, calib_factory({CALIB}): {n_tok} calibration tokens "
        f"(> d = {d}), chunk_layers=8")
    timings: dict = {}
    K3.reset()
    K4.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ccfg, cparams, rep = nbl_compress(cfg, params, fac, len(NBL_LAYERS),
                                      device=dev, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3_n, k4_n = K3.launches, K4.launches
    replays = math.ceil(n_attn / 8)
    want = (replays * CALIB["n_batches"] * n_attn,
            4 * n_attn * CALIB["n_batches"])
    log(f"  {wall:.1f} s: forward (taps) {timings['forward_s']:.2f} s, "
        f"moments (4 K4 launches a layer and batch, plus the float32 "
        f"casts and vector sums) {timings['moments_s']:.2f} s, finalize + "
        f"CCA + LMMSE (float64, torch.linalg) {timings['solve_s']:.2f} s; "
        f"{n_tok / wall:.0f} calibration tokens/s ({timings['tokens']} "
        f"tokens streamed over {replays} replays); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"  launches: K3 {k3_n} (= {replays} replays x "
        f"{CALIB['n_batches']} batches x {n_attn} layers: {k3_n == want[0]}),"
        f" K4 {k4_n} (= 4 x {n_attn} layers x {CALIB['n_batches']} batches: "
        f"{k4_n == want[1]})")
    bad = [i for i in rep.bounds
           if not (math.isfinite(rep.bounds[i]) and 0 <= rep.bounds[i] <= d
                   and rep.nmse[i] <= rep.bounds[i] + 1e-6)]
    log(f"  chosen layers (lowest bound first): {rep.layers}")
    for i in sorted(rep.bounds):
        log(f"    layer {i:2d}: bound {rep.bounds[i]:10.4f}  nmse "
            f"{rep.nmse[i]:.6f}  cos_dist {rep.cos_dists[i]:.6f}"
            f"{'  <- linearized' if i in rep.layers else ''}")
    log(f"  every bound finite, in [0, {d}], and nmse <= bound + 1e-6 "
        f"(Theorem 3.2): {not bad}; {len(set(rep.layers))} distinct layers "
        f"chosen")
    if (k3_n, k4_n) != want or bad or len(set(rep.layers)) != len(NBL_LAYERS):
        raise AssertionError(f"compression failed its checks: launches "
                             f"{(k3_n, k4_n)} != {want} or layers {bad} "
                             f"break the bound, or layers {rep.layers}")

    n_att, n_nbl = _kinds(ccfg)
    K1.reset()
    K2.reset()
    run = _serve_llama(torch, ccfg, cparams, prompts, dev)
    k1_n, k2_n, disp = K1.launches, K2.launches, run["dispatches"]
    log(f"  the compressed NBL-{n_nbl} model served (Engine, paged, chunked): "
        f"{run['tokens']} tokens in {run['wall_s']:.3f} s -> "
        f"{run['tok_s']:.1f} generated tok/s, {disp} fused steps; K1 "
        f"{k1_n} (= {n_att} x {disp}: {k1_n == n_att * disp}), K2 {k2_n} "
        f"(= {n_nbl} x {disp}: {k2_n == n_nbl * disp})")
    if k1_n != n_att * disp or k2_n != n_nbl * disp or disp == 0:
        raise AssertionError("the compressed model was not served through "
                             "K1 and K2")
    ctx.update(k4_launches=k4_n, compress_s=wall)


# --------------------------------------------------------------- table ----

def _k1_bound(row_pos, row_len, kv, rep, hd, ps, tbl, dtype_bytes, ops_peak):
    """Least time for the K1 call on these rows: the K/V bytes the valid
    rows attend (each allocated page read once), q and out of the valid
    rows; the QK and PV flops of those rows."""
    kv_tokens = 0
    q_rows = 0
    flops = 0
    for b in range(len(row_len)):
        n = int(row_len[b])
        if n == 0:
            continue
        last = int(row_pos[b]) + n - 1
        pages = sum(1 for lp in range(last // ps + 1) if tbl[b, lp] >= 0)
        kv_tokens += min(pages * ps, last + 1)
        q_rows += n
        for w in range(n):
            flops += 4 * hd * kv * rep * (int(row_pos[b]) + w + 1)
    nbytes = dtype_bytes * (2 * kv_tokens * kv * hd + 2 * q_rows * kv * rep * hd)
    tb, to = nbytes / HBM_BYTES_S, flops / ops_peak
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _k2_bound(m, k, n, dtype_bytes, ops_peak):
    nbytes = dtype_bytes * (m * k + k * n + n + m * n)
    tb, to = nbytes / HBM_BYTES_S, 2.0 * m * k * n / ops_peak
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _sdpa_inputs(torch, q, kp, vp, tbl, rp, rl):
    """Gathered K/V, q as (B, H, W, hd) and the boolean mask, for the
    library yardstick (set-up, outside the timed call)."""
    b, kv, rep, w, hd = q.shape
    ps = kp.shape[2]
    idx = tbl.clamp(min=0).long()
    kg = kp[idx].permute(0, 2, 1, 3, 4).reshape(b, kv, -1, hd)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(b, kv, -1, hd)
    t = torch.arange(kg.shape[2], device=q.device)
    qpos = rp.long()[:, None] + torch.arange(w, device=q.device)[None]
    mask = (t[None, None] <= qpos[:, :, None]) \
        & (tbl >= 0).repeat_interleave(ps, dim=1)[:, None, :]
    return q.reshape(b, kv * rep, w, hd), kg, vg, mask[:, None]


def phase_table(torch, dev, ctx, errs):
    import torch.nn.functional as F
    from repro_torch.kernels.nbl_linear import nbl_linear, nbl_linear_ref
    from repro_torch.kernels.paged_attention import paged_mixed, paged_mixed_ref

    cfg, params, eng, record = (ctx["cfg"], ctx["params"], ctx["engine"],
                                ctx["record"])
    kv, rep, hd, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.head_dim, cfg.d_model
    ps = eng.page_size
    dec = max((r for r in record if r["width"] == 1),
              key=lambda r: (r["n_decode"], int(r["row_pos"].max())))
    # the W=512 chunk step with the most prompt tokens (then the deepest)
    chk = max((r for r in record if r["width"] == 512),
              key=lambda r: (int(r["row_len"][r["row_len"] > 1].sum()),
                             int(r["row_pos"].max())))
    pools = [c for c in eng.cache["layers"] if c is not None]
    nbl_maps = [p["mixer"] for b, p in zip(cfg.blocks(), params["layers"])
                if b.kind == "nbl"]
    gen = torch.Generator(device=dev).manual_seed(7)
    peak = PEAK_OPS_S["bfloat16"]
    out = {}

    for tag, r in (("decode", dec), ("chunk512", chk)):
        w = r["width"]
        rp = torch.from_numpy(r["row_pos"]).to(dev)
        rl = torch.from_numpy(r["row_len"]).to(dev)
        tbl = torch.from_numpy(r["tbl"]).to(dev)
        q = torch.randn((eng.n_slots, kv, rep, w, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        args = [(q, c["k_pages"], c["v_pages"], tbl, rp, rl) for c in pools]
        iters = 40 if w == 1 else 10
        k_ms = _time_ms(paged_mixed, args, iters)
        p_ms = _time_ms(paged_mixed_ref, args[:2], 3 if w > 1 else 10, 1)
        sd = [_sdpa_inputs(torch, *a) for a in args[:4]]
        try:
            F.scaled_dot_product_attention(*sd[0][:3], attn_mask=sd[0][3],
                                           enable_gqa=True)
            gqa = dict(enable_gqa=True)
        except TypeError:          # older torch: repeat kv heads up front
            sd = [(a, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
                   m) for a, k, v, m in sd]
            gqa = {}
        l_ms = _time_ms(lambda a, k, v, m: F.scaled_dot_product_attention(
            a, k, v, attn_mask=m, **gqa), sd, iters)
        o = paged_mixed(*args[0])
        ref = paged_mixed_ref(*args[0])
        mask = _k1_valid_mask(torch, r["row_len"].tolist(), w, q.shape).to(dev)
        err = (o.float()[mask] - ref.float()[mask]).abs().max().item()
        b_ms, b_by = _k1_bound(r["row_pos"], r["row_len"], kv, rep, hd, ps,
                               r["tbl"], 2, peak)
        out[("paged_mixed", tag)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=l_ms,
                                         max_abs_err=err)
        log(f"  K1 paged_mixed  {tag:9s} W={w:3d} row_len "
            f"{r['row_len'].tolist()} row_pos {r['row_pos'].tolist()}")
        log(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa "
            f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| "
            f"{err:.2e}")

        m = eng.n_slots * w
        xs = [torch.randn((m, d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        args2 = [(xs[i % 2], mp["w"], mp["b"]) for i, mp in
                 enumerate(nbl_maps)]
        k_ms = _time_ms(nbl_linear, args2, 24 if w == 1 else 12)
        p_ms = _time_ms(nbl_linear_ref, args2, 12 if w == 1 else 4)
        l_ms = _time_ms(lambda x, wt, bb: torch.addmm(bb, x, wt).add_(x),
                        args2, 24 if w == 1 else 12)
        y = nbl_linear(*args2[0])
        err = (y.float() - nbl_linear_ref(*args2[0]).float()).abs().max().item()
        b_ms, b_by = _k2_bound(m, d, d, 2, peak)
        out[("nbl_linear", tag)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=l_ms,
                                        max_abs_err=err)
        log(f"  K2 nbl_linear   {tag:9s} M={m:4d} d={d}: kernel {k_ms:.4f} "
            f"ms, plain {p_ms:.4f} ms, addmm+add {l_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), max|err| {err:.2e}")

    for tag, s in (("s2048", 2048), ("s512", 512)):
        out[("flash_attention", tag)] = _k3_table_row(torch, gen, dev, cfg, s)

    k4 = _k4_table_row(torch, gen, dev, cfg.d_model)
    log(f"  ported kernels, launches on their path's run: paged_mixed "
        f"{ctx['k1_launches']} and nbl_linear {ctx['k2_launches']} (llama "
        f"phase, chunked), flash_attention {ctx['k3_launches']} (admit "
        f"phase), cov_accum {ctx['k4_launches']} (compress phase)")
    kernels = []
    for name, source, replaces, launches, perr, main, other in (
            ("paged_mixed", "src/repro_torch/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:129",
             ctx["k1_launches"], errs.get("k1", 0.0), "decode", "chunk512"),
            ("nbl_linear", "src/repro_torch/csrc/nbl_linear.cu",
             "src/repro/kernels/nbl_linear.py:59",
             ctx["k2_launches"], errs.get("k2", 0.0), "decode", "chunk512"),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:94",
             ctx["k3_launches"], errs.get("k3", 0.0), "s2048", "s512")):
        dd, cc = out[(name, main)], out[(name, other)]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=max(perr, dd["max_abs_err"], cc["max_abs_err"]),
            ms=dd["ms"], plain_ms=dd["plain_ms"], bound_ms=dd["bound_ms"],
            bound_by=dd["bound_by"], library_ms=dd["library_ms"],
            shape=("decode step (W=1)" if main == "decode" else
                   "admission prefill S=2048 (B=1, H=32, KV=8, hd=128, "
                   "causal)"),
            **{other: {k: cc[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}}))
    kernels.append(dict(
        name="cov_accum", route="cuda",
        source="src/repro_torch/csrc/cov_accum.cu",
        replaces="src/repro/kernels/cov_accum.py:53",
        launches=ctx["k4_launches"],
        max_abs_err=max(errs.get("k4", 0.0), k4["max_abs_err"]),
        **{k: k4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
        shape=f"one moment update of the compress phase: T={k4['t']} "
              f"tokens, Dy=Dx={cfg.d_model}, float32"))
    return kernels


def _k4_table_row(torch, gen, dev, d):
    """K4 at the compress phase's shape: one d x d moment update over one
    calibration batch (T tokens, float32 taps), from a running acc."""
    from repro_torch.kernels.cov_accum import cov_accum, cov_accum_ref
    t = CALIB["batch"] * CALIB["seq"]
    sets = [(torch.zeros((d, d), device=dev),
             torch.randn((t, d), generator=gen, device=dev),
             torch.randn((t, d), generator=gen, device=dev))
            for _ in range(2)]
    k_ms = _time_ms(cov_accum, sets, 20)
    p_ms = _time_ms(cov_accum_ref, sets, 6, 1)
    l_ms = _time_ms(lambda a, x, y: a.addmm_(y.t(), x), sets, 20)
    _, x, y = sets[0]
    acc = torch.zeros((d, d), device=dev)
    err = (cov_accum(acc, x, y) - cov_accum_ref(torch.zeros_like(acc), x, y)
           ).abs().max().item()
    # each input read once, acc read once and written once; 2*T*Dy*Dx
    # float32 operations on the CUDA cores
    nbytes = 4 * (2 * t * d + 2 * d * d)
    tb, to = nbytes / HBM_BYTES_S, 2.0 * t * d * d / PEAK_OPS_S["float32"]
    b_ms, b_by = 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")
    log(f"  K4 cov_accum    T={t} Dy=Dx={d} float32 (one moment update): "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, addmm_ {l_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max|err| {err:.2e}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms, max_abs_err=err, t=t)


def _k3_bound(qpos, kpos, b, h, kv, hd, dtype_bytes, ops_peak):
    """Least time for the K3 call: q, k, v and out once (and the
    positions); QK and PV flops of the (query, key) pairs this call's
    positions attend."""
    import torch
    from repro_torch.kernels.flash_attention import attend_mask
    s, t = len(qpos), len(kpos)
    pairs = int(attend_mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                            causal=True, window=None).sum())
    nbytes = dtype_bytes * b * hd * (2 * h * s + 2 * kv * t) + 4 * (s + t)
    tb, to = nbytes / HBM_BYTES_S, 4.0 * hd * b * h * pairs / ops_peak
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _k3_table_row(torch, gen, dev, cfg, s):
    """K3 at an admission shape: one prompt of s tokens, causal, bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    c = dict(h=h, kv=kv, hd=hd, pos=_causal(s))
    args = [_k3_inputs(torch, gen, dev, torch.bfloat16, c) for _ in range(4)]
    iters = 20 if s >= 2048 else 40
    k_ms = _time_ms(flash_attention, args, iters)
    p_ms = _time_ms(flash_attention_ref, args[:2], 4, 1)
    l_ms = _time_ms(lambda q, k, v, qp, kp: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), args, iters)
    err = (flash_attention(*args[0]).float()
           - flash_attention_ref(*args[0]).float()).abs().max().item()
    b_ms, b_by = _k3_bound(*c["pos"], 1, h, kv, hd, 2,
                           PEAK_OPS_S["bfloat16"])
    log(f"  K3 flash_attention admission S={s:4d} (B=1 H={h} KV={kv} "
        f"hd={hd}, causal): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa "
        f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max|err| {err:.2e}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms, max_abs_err=err)


# ------------------------------------------------------------- profile ----

def _family(name: str) -> str:
    low = name.lower()
    if "paged_mixed_kernel" in name:
        return "K1 paged_mixed"
    if "nbl_bf16_kernel" in name or "nbl_f32_kernel" in name:
        return "K2 nbl_linear"
    if "flash_bf16_kernel" in name or "flash_f32_kernel" in name:
        return "K3 flash_attention"
    if "cov_accum_kernel" in name:
        return "K4 cov_accum"
    if any(s in low for s in ("syevd", "sytrd", "stedc", "ormtr", "syev",
                              "getrf", "getrs", "laswp", "cusolver",
                              "lapack", "steqr", "larf", "latrd")):
        return "cuSOLVER (eigh, eigvalsh, solve)"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "cublas", "gemv",
                              "nvjet")):
        return "cuBLAS GEMM/GEMV (nvjet, cutlass)"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy/memset"
    return "other (elementwise, index, reduce)"


def _profiled(torch, fn):
    """Run fn under torch.profiler; returns (fn's result, wall s, device
    busy us, {family: us}, {kernel name: us})."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    fam: dict = {}
    names: dict = {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        fam[_family(e.name)] = fam.get(_family(e.name), 0.0) + us
        names[e.name] = names.get(e.name, 0.0) + us
    return res, wall, busy, fam, names


def _log_profile(wall, busy, fam, names):
    log(f"    device busy {busy / 1e3:.1f} ms = {100 * busy / (1e6 * wall):.1f}"
        f" % of the profiled wall {wall:.3f} s, idle "
        f"{100 * (1 - busy / (1e6 * wall)):.1f} %")
    for k, us in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"    {k:36s} {us / 1e3:9.1f} ms  {100 * us / busy:5.1f} % "
            "of busy")
    for k, us in sorted(names.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    top {us / 1e3:9.1f} ms  {k[:100]}")


def phase_profile(torch, dev, ctx):
    from repro_torch.launch.engine import Engine
    run, wall, busy, fam, names = _profiled(torch, lambda: _serve_llama(
        torch, ctx["cfg"], ctx["params"], ctx["prompts"], dev))
    log(f"  profiled NBL-12 chunked run: {run['dispatches']} steps "
        f"(unprofiled wall {ctx['wall_s']:.3f} s)")
    _log_profile(wall, busy, fam, names)

    # the 8 whole-prompt admissions alone (no step budget; the scheduler
    # admits 4 a call), each a prefill + page assignment + readback
    eng = Engine(ctx["cfg"], ctx["params"],
                 max_len=max(map(len, ctx["prompts"])) + 64, n_slots=8,
                 page_size=64, chunked_prefill=False, device=dev)
    for p in ctx["prompts"]:
        eng.submit(p, 64, strict=True)
    n, wall, busy, fam, names = _profiled(
        torch, lambda: eng._plan_admission() + eng._plan_admission())
    log(f"  profiled NBL-12 whole-prompt admissions: {n} admitted, "
        f"{eng.n_prefill_tokens} prompt tokens")
    _log_profile(wall, busy, fam, names)

    # one layer chunk of the compress phase's calibration (8 of the 32
    # layers: one replay of the stream, 8 finalize + CCA + LMMSE)
    from repro_torch.core import calibrate
    from repro_torch.data import calib_factory
    cfg, params, _, _, _ = _llama_model(torch, dev, ctx)
    _, wall, busy, fam, names = _profiled(torch, lambda: calibrate(
        cfg, params, calib_factory(cfg, **CALIB), layers=range(24, 32),
        device=dev))
    log(f"  profiled calibration of layers 24..31 (one replay of "
        f"{CALIB}; unprofiled, the compress phase's 32 layers took "
        f"{ctx.get('compress_s', float('nan')):.1f} s)")
    _log_profile(wall, busy, fam, names)


# ---------------------------------------------------------------- main ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES + EXTRA_PHASES} "
                         f"(default: {','.join(PHASES)})")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    ctx: dict = {}
    errs: dict = {}
    kernels = None
    t_all = time.perf_counter()
    with torch.no_grad():
        for ph in PHASES + EXTRA_PHASES:
            if ph not in phases:
                continue
            t0 = time.perf_counter()
            log(f"== phase {ph}")
            if ph == "card":
                log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
                    f"device: {kind}")
                log(f"  nvidia-smi name, power.limit: {smi_line}")
            elif ph == "build":
                from repro_torch.kernels import KERNEL_SOURCES, build_all
                from repro_torch.kernels._build import build_log
                build_all(KERNEL_SOURCES)
                log(f"  built {list(KERNEL_SOURCES)} in "
                    f"{time.perf_counter() - t0:.1f} s")
                for name, text in build_log.items():
                    for line in text.splitlines():
                        if "registers" in line or "spill" in line:
                            log(f"  ptxas {name}: {line.strip()}")
            elif ph == "k1":
                errs["k1"] = phase_k1(torch, dev)
            elif ph == "k2":
                errs["k2"] = phase_k2(torch, dev)
            elif ph == "k3":
                errs["k3"] = phase_k3(torch, dev)
            elif ph == "k4":
                errs["k4"] = phase_k4(torch, dev)
            elif ph == "tiny":
                phase_tiny(torch, dev)
            elif ph == "llama":
                phase_llama(torch, dev, ctx)
            elif ph == "admit":
                phase_admit(torch, dev, ctx)
            elif ph == "generate":
                phase_generate(torch, dev, ctx)
            elif ph == "compress":
                phase_compress(torch, dev, ctx)
            elif ph == "table":
                kernels = phase_table(torch, dev, ctx, errs)
            elif ph == "profile":
                phase_profile(torch, dev, ctx)
            log(f"   ({ph}: {time.perf_counter() - t0:.1f} s)")
    log(f"== all phases passed in {time.perf_counter() - t_all:.1f} s")
    if not set(PHASES) <= set(phases):
        return 0                   # a partial run prints no result
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
