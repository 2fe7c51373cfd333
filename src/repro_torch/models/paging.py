"""Paged KV cache: page pools, refcounted page allocator, page arithmetic.

Port of the parts of ``repro.models.paging`` the paged engine runs. Every
caching attention layer owns one pool pair
``k_pages / v_pages: (n_pages, KV, page_size, hd)``. Pages are
POSITION-ALIGNED: logical page ``l`` of a request holds absolute positions
[l*page_size, (l+1)*page_size), so validity follows from the request's
length and no per-token position array exists. One page TABLE, shared by
all layers, lives on the host as an ``(n_slots, pages_per_seq)`` int32
array, -1 = unallocated.

The allocator is host-side and refcounted: ``alloc`` hands pages out at
refcount 1, ``ref`` pins extra holders, ``unref`` (alias ``free``) drops
one reference and a page returns to the free list only at refcount 0.
``ref`` and ``unref`` validate the whole id list before any mutation, so a
rejected call changes nothing. ``alloc(0)`` returns ``[]``, as in the JAX
package. Linearized (nbl/drop) layers carry no pool at all.
``assign_pages`` writes an admission prefill's position-aligned cache into
the pools.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype

DEFAULT_PAGE_SIZE = 64


def pages_per_seq(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def span_pages(start_tok: int, end_tok: int,
               page_size: int) -> tuple[int, int]:
    """Logical page range [start_pg, end_pg) covering the token span
    [start_tok, end_tok). ``start_tok`` must be page-aligned: a chunk
    resumes only on a page boundary."""
    assert start_tok % page_size == 0, (start_tok, page_size)
    assert end_tok > start_tok, (start_tok, end_tok)
    return start_tok // page_size, pages_per_seq(end_tok, page_size)


def n_caching_attn_layers(cfg: ModelConfig) -> int:
    """Attention invocations that carry a KV pool (nbl/drop contribute 0)."""
    return sum(1 for b in cfg.blocks() if b.kind == "attn")


def page_bytes(cfg: ModelConfig, page_size: int) -> int:
    """Bytes of ONE page in ONE attention layer (K + V)."""
    itemsize = torch.empty((), dtype=torch_dtype(cfg.compute_dtype)).element_size()
    return 2 * page_size * cfg.n_kv_heads * cfg.head_dim * itemsize


def pool_pages_for_budget(cfg: ModelConfig, budget_bytes: int,
                          page_size: int) -> Optional[int]:
    """Per-layer pool size (pages) a byte budget buys across all caching
    layers. None when the stack has no caching attention layer at all."""
    a = n_caching_attn_layers(cfg)
    if a == 0:
        return None
    return int(budget_bytes // (a * page_bytes(cfg, page_size)))


def init_paged_cache(cfg: ModelConfig, n_slots: int, max_len: int, *,
                     page_size: int = DEFAULT_PAGE_SIZE,
                     n_pages: Optional[int] = None, device="cuda") -> dict:
    """Paged cache ``{"layers": [...]}``: one ``{"k_pages", "v_pages"}``
    pool pair (n_pages, KV, page_size, hd) per attention layer, in
    ``cfg.blocks()`` order, and None for every other block."""
    dev = resolve_device(device)
    if n_pages is None:
        n_pages = n_slots * pages_per_seq(max_len, page_size)
    dt = torch_dtype(cfg.compute_dtype)
    shp = (n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    layers = []
    for blk in cfg.blocks():
        if blk.kind == "attn":
            layers.append({"k_pages": torch.zeros(shp, dtype=dt, device=dev),
                           "v_pages": torch.zeros(shp, dtype=dt, device=dev)})
        elif blk.kind in ("nbl", "nbl_block", "drop", "drop_block"):
            layers.append(None)
        else:
            raise NotImplementedError(
                f"block kind {blk.kind!r} keeps no paged state in this slice "
                "of the port; see ROADMAP.md §A8")
    return {"layers": layers}


def sanitize_page_ids(ids: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Map unallocated (-1) entries to the out-of-range id ``n_pages``, as
    the JAX package does before its ``mode="drop"`` scatters; the port's
    scatters then keep only ids < n_pages (torch has no drop mode)."""
    return torch.where(ids >= 0, ids, torch.full_like(ids, n_pages)).int()


def assign_pages(cfg: ModelConfig, paged_cache: dict, prefill_cache: dict,
                 page_ids: torch.Tensor, *, page_size: int) -> dict:
    """Write a batch-1 POSITION-ALIGNED prefill cache into the page pools,
    in place.

    ``prefill_cache`` comes from ``prefill(..., paged=True)`` with
    ``cache_len`` a page multiple. ``page_ids`` holds >= cache_len //
    page_size int32 entries (a page-table row is fine): entry i is the
    physical page of logical page i, -1 for a page that was never
    allocated (bucket padding), whose tile is DROPPED, never written. The
    JAX version also takes the slot, for the slot-indexed state of block
    kinds the port does not carry yet (ROADMAP.md §A8)."""
    keep = ids = None          # every layer's cache has the same length
    for blk, dst, src in zip(cfg.blocks(), paged_cache["layers"],
                             prefill_cache["layers"]):
        if blk.kind != "attn":
            continue
        for dk, sk in (("k_pages", "k"), ("v_pages", "v")):
            pool, kv = dst[dk], src[sk]              # kv: (1, KV, S, hd)
            _, kvh, s, hd = kv.shape
            npg = s // page_size
            if keep is None:
                assert npg * page_size == s and npg <= page_ids.shape[0], \
                    (s, page_size, tuple(page_ids.shape))
                ids = sanitize_page_ids(page_ids[:npg], pool.shape[0])
                keep = torch.nonzero(ids < pool.shape[0]).squeeze(1)
                ids = ids[keep].long()
            tiles = kv[0].reshape(kvh, npg, page_size, hd).transpose(0, 1)
            pool[ids] = tiles[keep].to(pool.dtype)
    return paged_cache


def build_page_table(n_slots: int, max_len: int,
                     page_size: int) -> np.ndarray:
    return np.full((n_slots, pages_per_seq(max_len, page_size)), -1, np.int32)


class DoubleFreeError(RuntimeError):
    pass


@dataclass
class PageAllocator:
    """Host-side REFCOUNTED free-list allocator over page ids [0, n_pages).

    ``alloc`` is all-or-nothing (None when the pool cannot satisfy the
    request) and hands pages out at refcount 1; ``ref`` / ``unref`` are
    atomic (see the module docstring). Step-thread-only: no locks."""
    n_pages: int
    _free: list = field(default_factory=list)
    _refs: dict = field(default_factory=dict)     # pid -> refcount >= 1
    peak_in_use: int = 0

    def __post_init__(self):
        self._free = list(range(self.n_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._refs)

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            self._refs[pid] = 1
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return ids

    def ref(self, ids) -> None:
        """Add one reference per occurrence of each id; every id must be
        allocated or nothing is referenced."""
        ids = list(ids)
        for pid in ids:
            if pid not in self._refs:
                raise DoubleFreeError(f"page {pid} is not allocated")
        for pid in ids:
            self._refs[pid] += 1

    def unref(self, ids) -> None:
        """Drop one reference per occurrence of each id; a page returns to
        the free list at refcount 0. The whole list (duplicates counted per
        occurrence) is validated before any mutation."""
        ids = list(ids)
        need: dict = {}
        for pid in ids:
            need[pid] = need.get(pid, 0) + 1
        for pid, n in need.items():
            if self._refs.get(pid, 0) < n:
                raise DoubleFreeError(
                    f"page {pid}: {n} release(s) requested but refcount is "
                    f"{self._refs.get(pid, 0)}")
        for pid in ids:
            self._refs[pid] -= 1
            if self._refs[pid] == 0:
                del self._refs[pid]
                self._free.append(pid)

    free = unref

    def check_invariants(self) -> None:
        """Referenced and free pages partition [0, n_pages), and every live
        refcount is >= 1."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate ids on free list"
        assert not (free & self._refs.keys()), "page both free and referenced"
        assert free | self._refs.keys() == set(range(self.n_pages)), \
            "page lost"
        assert all(c >= 1 for c in self._refs.values()), "zombie refcount"
