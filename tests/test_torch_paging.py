"""PyTorch port vs JAX reference: the paged-KV host state. The same
operation sequences through both allocators give the same page ids,
refcounts and errors; the page arithmetic, pool sizing and NBL page
budget agree; the port's paged cache has the JAX pools' shapes."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from tests._hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.surgery import nbl_variant as jax_nbl_variant  # noqa: E402
from repro.launch.scheduler import nbl_page_budget as jax_budget  # noqa: E402
from repro.models import paging as jp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.surgery import nbl_variant  # noqa: E402
from repro_torch.launch.scheduler import nbl_page_budget  # noqa: E402
from repro_torch.models import paging as tp  # noqa: E402


def _both(n_pages):
    return tp.PageAllocator(n_pages), jp.PageAllocator(n_pages)


def _same_state(a, b):
    assert a._free == b._free
    assert a._refs == b._refs
    assert (a.free_pages, a.in_use, a.peak_in_use) \
        == (b.free_pages, b.in_use, b.peak_in_use)


def test_allocator_basic():
    a, b = _both(4)
    for n in (2, 0, 1):
        assert a.alloc(n) == b.alloc(n)
        _same_state(a, b)
    assert a.alloc(0) == [] == b.alloc(0)          # alloc(0) stays []
    assert a.alloc(5) is None and b.alloc(5) is None
    with pytest.raises(ValueError):
        a.alloc(-1)
    a.free([0, 1])
    b.free([0, 1])
    _same_state(a, b)
    a.check_invariants()


def test_allocator_refcounts():
    a, b = _both(4)
    ids = a.alloc(2)
    assert ids == b.alloc(2)
    for alloc in (a, b):
        alloc.ref(ids)
        alloc.ref([ids[0]])
        alloc.unref(ids)
    _same_state(a, b)
    assert a.refcount(ids[0]) == 2 and a.refcount(ids[1]) == 1
    with pytest.raises(tp.DoubleFreeError):
        a.ref([3])                                  # not allocated
    a.check_invariants()


def test_allocator_unref_is_atomic():
    """A rejected unref (one id over-released, duplicates counted per
    occurrence) changes nothing, in both packages alike."""
    a, b = _both(4)
    ids = a.alloc(3)
    b.alloc(3)
    for alloc, err in ((a, tp.DoubleFreeError), (b, jp.DoubleFreeError)):
        with pytest.raises(err):
            alloc.unref([ids[0], ids[1], ids[1]])
    _same_state(a, b)
    assert all(a.refcount(p) == 1 for p in ids)


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(1, 9)),
                min_size=1, max_size=40))
def test_allocator_lockstep_property(ops):
    """Any alloc/ref/unref interleaving (with invalid over-releases mixed
    in) keeps the two allocators identical and their invariants intact.
    Groups are drawn with n >= 1: ``alloc(0)`` returns ``[]`` in both
    packages, and an empty group cannot be over-released."""
    a, b = _both(8)
    held: list[list[int]] = []
    for op, n in ops:
        if op == 0:
            got = a.alloc(n)
            assert got == b.alloc(n)
            if got is not None:
                held.append(got)
        elif op == 1 and held:
            grp = held[n % len(held)]
            a.ref(grp)
            b.ref(grp)
            held.append(list(grp))
        elif op == 2 and held:
            grp = held.pop(n % len(held))
            a.unref(grp)
            b.unref(grp)
        elif op == 3:
            grp = held[n % len(held)] if held else [n]
            over = [p for p in grp for _ in range(a.refcount(p) + 1)]
            with pytest.raises(tp.DoubleFreeError):
                a.unref(over)
            with pytest.raises(jp.DoubleFreeError):
                b.unref(over)
        _same_state(a, b)
        a.check_invariants()


def test_page_arithmetic_matches_jax():
    for n in (1, 2, 3, 4, 5, 8, 9, 1000):
        assert tp.pow2_ceil(n) == jp.pow2_ceil(n)
        for ps in (4, 8, 64):
            assert tp.pages_per_seq(n, ps) == jp.pages_per_seq(n, ps)
    assert tp.span_pages(8, 20, 4) == jp.span_pages(8, 20, 4) == (2, 5)
    assert tp.span_pages(0, 1, 8) == jp.span_pages(0, 1, 8) == (0, 1)
    with pytest.raises(AssertionError):
        tp.span_pages(3, 8, 4)                      # must resume on a page
    np.testing.assert_array_equal(tp.build_page_table(3, 20, 8),
                                  jp.build_page_table(3, 20, 8))


@pytest.mark.parametrize("arch", ["tiny-dense", "tiny-swa", "tiny-gemma"])
def test_pool_sizing_and_budget_match_jax(arch):
    """Caching-layer counts, page bytes, pool pages and the NBL page budget
    agree at every linearization depth (linearized layers bill zero)."""
    for m in range(0, 4):
        tc, jc = nbl_variant(get_config(arch), m), \
            jax_nbl_variant(jax_config(arch), m)
        assert tp.n_caching_attn_layers(tc) == jp.n_caching_attn_layers(jc)
        assert tp.page_bytes(tc, 8) == jp.page_bytes(jc, 8)
        budget = 6 * tp.n_caching_attn_layers(tc) * tp.page_bytes(tc, 8)
        assert tp.pool_pages_for_budget(tc, budget, 8) \
            == jp.pool_pages_for_budget(jc, budget, 8)
        for exp in (8, 20, 40):
            assert nbl_page_budget(tc, budget, page_size=8, expected_len=exp) \
                == jax_budget(jc, budget, page_size=8, expected_len=exp)


def test_init_paged_cache_shapes_match_jax():
    """Per attention layer, the port's pool equals the JAX pool unstacked
    along the group's scan dim; linearized layers carry no pool."""
    tc, jc = nbl_variant(get_config("tiny-dense"), 2), \
        jax_nbl_variant(jax_config("tiny-dense"), 2)
    tcache = tp.init_paged_cache(tc, 3, 20, page_size=4, device="cpu")
    jcache = jp.init_paged_cache(jc, 3, 20, page_size=4)
    jshapes = []
    for g, grp in zip(jc.stack, jcache["groups"]):
        for _ in range(g.repeat):
            for blk, c in zip(g.unit, grp["blocks"]):
                jshapes.append(tuple(c["k_pages"].shape[1:])
                               if blk.kind == "attn" else None)
    tshapes = [None if c is None else tuple(c["k_pages"].shape)
               for c in tcache["layers"]]
    assert tshapes == jshapes
    assert tshapes[-2:] == [None, None]
    assert all((c["v_pages"] == 0).all() for c in tcache["layers"] if c)
