"""The port's paged KV cache against the JAX reference: the page pool step by
step, the paged write and gather primitives, the paged forward step, and the
paged engine (prefix sharing, copy-on-write, shedding, capacity checks, fp8
storage) against the port's dense engine and the reference's paged engine.

Same seeded inputs through both packages; the reference's LUT sites run
Pallas in interpret mode, the port's the plain versions of its kernels."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as jattn
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.kv_pool import KVPagePool as JKVPagePool
from repro_torch import configs as tcfg
from repro_torch.kernels import counters
from repro_torch.models import attention as tattn
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_pool import KVPagePool
from repro_torch.weights import params_from_numpy

ATOL, RTOL = 1e-4, 1e-4          # as tests/test_torch_model.py: logits to float rounding


@functools.lru_cache(maxsize=None)
def _models(n_layers=2):
    """Reduced qwen3_1p7b in LUT_INFER (kernel sites) in both packages, from
    the reference's init carried over as numpy. Callers never write params."""
    kw = dict(n_layers=n_layers, d_model=64, vocab=128, d_ff=128, lut_use_kernel=True)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    tb = tcfg.build_model(tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), **kw), "lut_infer")
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tb, jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


# ---------------------------------------------------------------------------
# the page pool, step by step (the cases of tests/test_kv_pool.py:33-92)
# ---------------------------------------------------------------------------

def _raises(fn, *args):
    try:
        fn(*args)
    except ValueError:
        return "ValueError"
    return None


def _case_refcount(pool, rec):
    pages = [rec(pool.alloc()) for _ in range(4)]
    rec(pool.alloc())                          # exhausted: None, never raises
    pool.ref(pages[0])
    rec()
    pool.unref(pages[0])
    rec()
    for p in pages:
        pool.unref(p)
        rec()
    rec(_raises(pool.unref, pages[0]))        # double free
    rec(_raises(pool.ref, 0))                 # the garbage page


def _case_prefix(pool, rec):
    a, b = rec(pool.alloc()), rec(pool.alloc())
    rec(pool.register_prefix((1, 2), a))
    rec(pool.register_prefix((1, 2, 3, 4), b))
    rec(pool.register_prefix((1, 2), 99))     # first writer wins
    rec(pool.register_prefix((9, 9), a))      # a page keeps its one key
    rec(pool.lookup_prefix([1, 2, 3, 4, 5]))
    rec(pool.lookup_prefix([7, 7, 7]))
    for p in (a, b):                          # retire every holder
        while pool.refcount[p] > 0:
            pool.unref(p)
            rec()
    rec(pool.alloc())                         # the free list first
    rec(pool.alloc())                         # then the oldest evictable page
    rec(pool.lookup_prefix([1, 2, 9]))
    rec((pool.needs_cow(a), pool.needs_cow(b), pool.is_registered(b)))


def _case_release(pool, rec):
    p = rec(pool.alloc())
    rec(pool.register_prefix((1, 2), p))
    rec(pool.lookup_prefix([1, 2]))
    pool.unref(p)
    rec()
    for _ in range(4):
        rec(pool.alloc())


POOL_CASES = {"refcount": (_case_refcount, 5, 8), "prefix": (_case_prefix, 4, 2),
              "release": (_case_release, 4, 2)}


def _trace(pool_cls, case, sharing):
    fn, n_pages, page_size = POOL_CASES[case]
    pool = pool_cls(n_pages, page_size, prefix_sharing=sharing)
    out = []

    def rec(result=None):
        out.append((result, dict(pool.counters), pool.n_allocatable, pool.n_free, pool.n_cached,
                    pool.n_resident, pool.n_shared, pool.peak_resident, pool.refcount.tolist()))
        return result

    fn(pool, rec)
    return out


@pytest.mark.parametrize("sharing", [True, False])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_steps_match_reference(case, sharing):
    """Every step returns the same page ids, counters and gauges."""
    assert _trace(KVPagePool, case, sharing) == _trace(JKVPagePool, case, sharing)


def test_pool_refuses_what_the_reference_refuses():
    for args in ((1, 8), (4, 0)):
        with pytest.raises(ValueError):
            KVPagePool(*args)
        with pytest.raises(ValueError):
            JKVPagePool(*args)
    assert tattn.GARBAGE_PAGE == jattn.GARBAGE_PAGE == 0


# ---------------------------------------------------------------------------
# paged primitives and the paged forward step
# ---------------------------------------------------------------------------

def _tables(rng, b, n_tables, n_pages):
    """Seeded block tables: distinct pages >= 1, some rows' tails unmapped (0)."""
    pages = rng.permutation(np.arange(1, n_pages))[: b * n_tables].reshape(b, n_tables)
    pages[0, n_tables // 2:] = 0
    return pages.astype(np.int32)


@pytest.mark.parametrize("s,page_size", [(1, 4), (5, 4), (7, 8)])
def test_paged_write_flat_and_gather_match_reference(s, page_size):
    rng = np.random.default_rng(s)
    b, n_tables = 4, 4
    n_pages = b * n_tables + 3
    bt = _tables(rng, b, n_tables, n_pages)
    cache_len = np.array([0, 3, n_tables * page_size - 2, 9], np.int32)
    write_len = np.array([s, 0, s, max(s - 2, 0)], np.int32)   # a masked row, a short one
    want = np.asarray(jattn.paged_write_flat(jnp.asarray(bt), jnp.asarray(cache_len), s,
                                             page_size, jnp.asarray(write_len)))
    got = tattn.paged_write_flat(torch.from_numpy(bt), torch.from_numpy(cache_len), s,
                                 page_size, torch.from_numpy(write_len))
    np.testing.assert_array_equal(got.numpy(), want)
    # masked offsets, rows and positions past the table land in page 0
    assert (got[1] < page_size).all() and (got[:, s:] == 0).all()
    pool = rng.standard_normal((n_pages, page_size, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tattn.paged_gather(torch.from_numpy(pool), torch.from_numpy(bt)).numpy(),
        np.asarray(jattn.paged_gather(jnp.asarray(pool), jnp.asarray(bt))))


def test_forward_step_paged_matches_reference():
    """A prefill chunk and two decode steps through a paged cache with seeded,
    scattered block tables and a masked row: logits and every page but the
    garbage page agree with the reference."""
    jb, jparams, tb, tparams = _models()
    rng = np.random.default_rng(0)
    b, s_max, page_size, chunk = 3, 16, 4, 6
    n_tables = s_max // page_size
    n_pages = b * n_tables + 2
    bt = rng.permutation(np.arange(1, n_pages))[: b * n_tables].reshape(b, n_tables)
    bt = bt.astype(np.int32)
    bt[2, 1:] = 0                     # row 2 never writes; its tail is unmapped
    jc = jb.init_caches(b, s_max, dtype=jnp.float32,
                        paged=jattn.PagedSpec(n_pages=n_pages, page_size=page_size))
    tc = tb.init_caches(b, s_max, dtype=torch.float32, device="cpu",
                        paged=tattn.PagedSpec(n_pages=n_pages, page_size=page_size))
    cache_len = np.zeros((b,), np.int32)
    write_len = np.array([chunk, chunk - 2, 0], np.int32)           # row 2 sits this out
    toks = rng.integers(0, 128, (b, chunk)).astype(np.int32)
    for step in range(3):
        jbatch = {"tokens": jnp.asarray(toks), "cache_len": jnp.asarray(cache_len),
                  "block_tables": jnp.asarray(bt), "write_len": jnp.asarray(write_len)}
        jl, jc = jb.forward_step(jparams, jbatch, jc, compute_dtype=jnp.float32)
        tbatch = {"tokens": torch.from_numpy(toks), "cache_len": torch.from_numpy(cache_len),
                  "block_tables": torch.from_numpy(bt), "write_len": torch.from_numpy(write_len)}
        with torch.inference_mode():
            tl, tc = tb.forward_step(tparams, tbatch, tc, compute_dtype=torch.float32)
        valid = [i for i in range(b) if write_len[i]]
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], atol=ATOL, rtol=RTOL)
        for tseg, jseg in zip(tc, jc):
            for name in ("k_pool", "v_pool"):
                np.testing.assert_allclose(tseg[name][:, 1:].numpy(),
                                           np.asarray(jseg[name])[:, 1:], atol=ATOL, rtol=RTOL)
        cache_len = cache_len + write_len
        write_len = np.array([1, 1, 0], np.int32)
        toks = rng.integers(0, 128, (b, 1)).astype(np.int32)


def test_forward_step_refuses_mismatched_caches():
    _, _, tb, tparams = _models()
    toks = torch.zeros((1, 1), dtype=torch.int32)
    cl = torch.zeros((1,), dtype=torch.long)
    dense = tb.init_caches(1, 8, device="cpu")
    paged = tb.init_caches(1, 8, device="cpu", paged=tattn.PagedSpec(3, 4))
    with pytest.raises(ValueError, match="block_tables"):
        tb.forward_step(tparams, {"tokens": toks, "cache_len": cl}, paged)
    with pytest.raises(ValueError, match="block_tables"):
        tb.forward_step(tparams, {"tokens": toks, "cache_len": cl,
                                  "block_tables": torch.ones((1, 2), dtype=torch.int32)}, dense)


# ---------------------------------------------------------------------------
# the paged engine: port paged == port dense == reference paged
# ---------------------------------------------------------------------------

POOL_KEYS = ("prefix_hits", "prefix_lookups", "cow_copies", "prefix_evictions",
             "alloc_failures", "kv_pages_peak", "kv_pages_total", "kv_pages_cached",
             "kv_pages_resident", "kv_pages_free", "kv_pages_shared", "shed",
             "prefill_tokens_skipped")
FORWARD_KEYS = ("steps", "prefill_forwards", "prefill_tokens", "decode_forwards",
                "decode_tokens", "completed", "shape_cache_hits")


def _run(eng, prompts, max_tokens=5):
    for p in prompts:
        eng.submit(list(p), max_tokens=max_tokens)
    done = sorted(eng.run_until_done(), key=lambda r: r.rid)
    return [(r.rid, r.status, r.out_tokens) for r in done]


def _three_engines(prompts, max_tokens=5, **kw):
    """(port paged, port dense, reference paged) results and the two paged
    engines' stats. `kw`: engine kwargs; paged ones go to the paged engines."""
    jb, jparams, tb, tparams = _models()
    paged_kw = {k: kw.pop(k) for k in ("page_size", "n_pages", "prefix_sharing") if k in kw}
    counters.reset()
    tp = ServingEngine(tb, tparams, device="cpu", autotune_lut=False, paged=True,
                       **paged_kw, **kw)
    td = ServingEngine(tb, tparams, device="cpu", autotune_lut=False, **kw)
    jp = JServingEngine(jb, jparams, autotune_lut=False, paged=True, **paged_kw, **kw)
    out = [_run(e, prompts, max_tokens) for e in (tp, td, jp)]
    assert sum(counters.launches().values()) == 0        # the CPU: plain versions only
    return out, tp.stats(), jp.stats()


def _assert_stats_equal(ts, js, keys=POOL_KEYS + FORWARD_KEYS):
    for key in keys:
        assert ts[key] == js[key], (key, ts[key], js[key])


@pytest.mark.parametrize("sharing", [True, False])
def test_paged_engine_matches_dense_and_reference(sharing):
    """Mixed prompt lengths cross page boundaries, repeat a prompt (a prefix
    hit when sharing) and take two chunks."""
    prompts = [[3, 5, 7], [11, 13, 17, 19, 23, 29, 31, 37, 41], [2, 4, 6, 8, 10, 12], [3, 5, 7],
               [1, 2, 3, 4, 5, 6, 7, 8], [11, 13, 17, 19, 23, 29, 31, 37, 41]]
    (tp, td, jp), ts, js = _three_engines(prompts, n_slots=3, max_seq=64, prefill_chunk=8,
                                          page_size=8, prefix_sharing=sharing)
    assert tp == td == jp
    _assert_stats_equal(ts, js)
    assert (ts["prefill_tokens_skipped"] > 0) == sharing


def test_prefix_sharing_skips_prefill_chunks():
    system = list(range(1, 25))               # 24 tokens = 3 pages of 8
    prompts = [system + [100 + i] for i in range(4)]
    (tp, td, jp), ts, js = _three_engines(prompts, n_slots=1, max_seq=64, prefill_chunk=8,
                                          page_size=8)
    assert tp == td == jp
    _assert_stats_equal(ts, js)
    assert ts["prefill_tokens_skipped"] == 3 * 24 and ts["kv_pages_cached"] >= 3


def test_fully_cached_prompt_copies_on_write():
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8]]
    (tp, td, jp), ts, js = _three_engines(prompts, n_slots=1, max_seq=32, prefill_chunk=8,
                                          page_size=8)
    assert tp == td == jp
    _assert_stats_equal(ts, js)
    assert ts["cow_copies"] >= 1 and ts["prefill_tokens_skipped"] == 7


def test_pool_exhaustion_sheds_never_raises():
    """5 requests x 41 positions into 4 pages of 8: every victim retires
    "shed", one request completes, and the survivor's tokens match."""
    jb, jparams, tb, tparams = _models()
    kw = dict(n_slots=4, max_seq=64, prefill_chunk=8, autotune_lut=False, paged=True,
              page_size=8, n_pages=5)
    prompts = [[10 + i] * 11 for i in range(5)]
    tp = _run(ServingEngine(tb, tparams, device="cpu", **kw), prompts, max_tokens=30)
    jeng = JServingEngine(jb, jparams, **kw)
    jp = _run(jeng, prompts, max_tokens=30)
    assert tp == jp
    assert sorted(st for _, st, _ in tp) == ["ok", "shed", "shed", "shed", "shed"]
    assert jeng.stats()["shed"] == 4


def test_submit_capacity_checks_in_pages():
    _, _, tb, tparams = _models()
    eng = ServingEngine(tb, tparams, device="cpu", n_slots=1, max_seq=64, prefill_chunk=8,
                        autotune_lut=False, paged=True, page_size=8, n_pages=4)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(list(range(25)), max_tokens=1)          # needs 4 pages > 3
    rid = eng.submit(list(range(24)), max_tokens=50)       # exactly 3 pages: admitted
    req = next(r for r in eng.run_until_done() if r.rid == rid)
    assert req.status == "ok" and len(req.out_tokens) == 1   # positions capped at 24
    assert eng.stats()["shed"] == 0
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(tb, tparams, device="cpu", max_seq=60, prefill_chunk=8, paged=True,
                      page_size=8, autotune_lut=False)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(tb, tparams, device="cpu", max_seq=64, kv_dtype="int4",
                      autotune_lut=False)


def test_fp8_kv_paged_matches_dense_and_reference():
    """fp8 storage quantizes the same values in both layouts: the port's
    paged and dense engines agree, and agree with the reference's."""
    prompts = [[3, 5, 7, 9, 11], [2, 4, 6], [3, 5, 7, 9, 11]]
    (tp, td, jp), ts, js = _three_engines(prompts, max_tokens=4, n_slots=2, max_seq=32,
                                          prefill_chunk=4, page_size=4,
                                          kv_dtype="float8_e4m3fn")
    assert tp == td == jp
    _assert_stats_equal(ts, js)
    eng = ServingEngine(_models()[2], _models()[3], device="cpu", n_slots=2, max_seq=32,
                        prefill_chunk=4, autotune_lut=False, paged=True, page_size=4,
                        kv_dtype="float8_e4m3fn")
    assert all(t.dtype == torch.float8_e4m3fn for seg in eng.caches for t in seg.values())
    st = eng.stats()
    assert st["kv_bytes_dense_equiv"] == eng._page_bytes * 2 * 8   # a quarter of fp32's
