"""Parity of the port's block-paged KV cache (``rten_tpu_torch`` on the CPU,
where the kernels' plain versions run) against the JAX package (CPU
backend, Pallas in interpret mode), on inputs drawn with numpy: the appends
``kv_append_paged`` (``paged_append``) and ``kv_append_paged_int8``
(``paged_append_quant``), the attention kernels ``decode_attn_paged``,
``decode_attn_paged_int8`` (``flash_decode_paged_grouped``) and
``decode_attn_paged_grid`` (``flash_decode_paged``), the page allocator,
then the model and the engine on paged caches."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.paged_cache import PagedKVCache as JPagedKVCache
from rten_tpu.kernels.attention import (flash_decode_paged,
                                        flash_decode_paged_grouped)
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import PagedKVCache, ServingEngine
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy)
from rten_tpu_torch.models import transformer as ptr
from test_torch_kernels import port_layout

# Two kv heads of 64 make 128-lane rows, so the reference takes its Pallas
# append kernels; pages of 8 tokens.
KVH, D, PAGE = 2, 64, 8
F = KVH * D
# The reference's own tolerances (tests/test_paged_cache.py:104-105,
# 207-208 for float pools, :270-271 for int8 pools).
FLOAT_TOL = 2e-5
INT8_TOL = 2e-4
# Teacher-forced logits: f32 weights on an f32 pool agree to 1e-4, int8
# weights to 1e-2 (tests/test_torch_decode_paths.py, the no-tail int8
# path).
F32_LOGIT_TOL = 1e-4
LOGIT_TOL = 1e-2
CFG = dict(n_heads=2, d_model=128)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with(jc, table=None, lengths=None):
    """The JAX cache with another table and/or lengths."""
    return JPagedKVCache(
        jc.pools, jc.page_table if table is None else jnp.asarray(table),
        jc.lengths if lengths is None else jnp.asarray(lengths, jnp.int32),
        jc.page_size, jc.kv_heads, jc.head_dim, quant_scales=jc.quant_scales)


def _pools(jc, layer=0):
    """The JAX pool of ``layer`` in the port's layout: f32 [n_pages, page,
    2, F], or int8 [n_pages, page, 2, F] with bf16 scales [n_pages, page,
    2, KVH] (the reference's token-packed pages and pair-packed scale pages
    read back like a contiguous cache's rows)."""
    if jc.quant_scales is None:
        return _t(np.asarray(jc.pools[layer])), None
    return port_layout(SimpleNamespace(kv_heads=jc.kv_heads, kv=jc.pools,
                                       quant_scales=jc.quant_scales), layer)


def _port_cache(jc, layer=0):
    """The port's cache holding the same pages, table and lengths."""
    pool, scales = _pools(jc, layer)
    return PagedKVCache([pool], _t(jc.page_table), _t(jc.lengths),
                        jc.page_size, jc.kv_heads, jc.head_dim,
                        None if scales is None else [scales])


def _scrambled_table(rng, b, max_pages, lengths, n_pages):
    """Page ids for ceil(len / page) pages per sequence, drawn without
    replacement from 1..n_pages-1 in a scrambled order; the rest -1."""
    ids = list(rng.permutation(np.arange(1, n_pages)))
    table = np.full((b, max_pages), -1, np.int32)
    for i, n in enumerate(lengths):
        for p in range(-(-n // PAGE)):
            table[i, p] = ids.pop()
    return table


# -- P1 / P2: prefill and decode appends --------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_appends_bit_exact_against_reference(quantized):
    """Prefill at T = 3 pages + 5 (not a page multiple) scatters the same
    padded pages as the reference; then decode appends (P1 / P2 plain)
    write the same bytes and scales as ``paged_append`` /
    ``paged_append_quant``, mid-page, at a page boundary, at a page's last
    row, past capacity, and for a released slot (table row -1) into page
    0 — bit for bit over the whole pool, and through ``layer_kv``."""
    rng = np.random.default_rng(10 + quantized)
    b, max_pages, n_pages, t = 5, 4, 24, 3 * PAGE + 5
    table = _scrambled_table(rng, b, max_pages, [max_pages * PAGE] * b,
                             n_pages)
    jc = _with(JPagedKVCache.create(1, n_pages, PAGE, KVH, D, b, max_pages,
                                    quantized=quantized), table=table)
    pc = _port_cache(jc)
    k, v = (rng.standard_normal((b, KVH, t, D)).astype(np.float32)
            * np.exp(rng.uniform(-3, 3, (b, KVH, t, 1))).astype(np.float32)
            for _ in range(2))
    k[0, 1, 2] = 0.0                         # an all-zero head: scale 1.0
    jc = jc.append(0, jnp.asarray(k), jnp.asarray(v), position=0)
    pc = pc.append(0, _t(k), _t(v), position=0)
    want = _pools(jc)
    assert torch.equal(pc.pools[0], want[0])
    if quantized:
        assert torch.equal(pc.scales[0], want[1])

    lengths = np.array([3, PAGE, 2 * PAGE - 1, max_pages * PAGE + 3, 5],
                       np.int32)
    table[4] = -1                            # slot 4 was released
    jc = _with(jc, table=table, lengths=lengths)
    pc.page_table.copy_(_t(table))
    pc = pc.with_lengths(lengths)
    k1, v1 = (rng.standard_normal((b, KVH, 1, D)).astype(np.float32)
              for _ in range(2))
    jc = jc.append(0, jnp.asarray(k1), jnp.asarray(v1))
    pc = pc.append(0, _t(k1), _t(v1))
    want = _pools(jc)
    assert torch.equal(pc.pools[0], want[0])
    if quantized:
        assert torch.equal(pc.scales[0], want[1])
        assert pc.scales[0][table[0, 0], 2, 0, 1].item() == 1.0
    jk, jv = jc.layer_kv(0)
    pk, pv = pc.layer_kv(0)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    if not quantized:
        # The released slot's append landed in the garbage page.
        np.testing.assert_array_equal(
            pc.pools[0][0, 5].numpy(),
            np.stack([k1[4].reshape(F), v1[4].reshape(F)]))


@pytest.mark.parametrize("quantized", [False, True])
def test_inserts_match_reference(quantized):
    """Adopting a prefilled group cache (identity table) into a serving
    cache's scrambled pages: ``insert_group`` (the engine's one indexed
    copy per layer) and ``insert_sequence`` each give the pools and
    lengths of the reference's ``insert_sequence``, bit for bit."""
    rng = np.random.default_rng(30 + quantized)
    g, b, max_pages, n_pages, t = 2, 3, 4, 16, PAGE + 3
    jg = _with(JPagedKVCache.create(1, 2 * g, PAGE, KVH, D, g, 2,
                                    quantized=quantized),
               table=np.arange(2 * g, dtype=np.int32).reshape(g, 2))
    k, v = (rng.standard_normal((g, KVH, t, D)).astype(np.float32)
            for _ in range(2))
    jg = jg.append(0, jnp.asarray(k), jnp.asarray(v), position=0)
    table = _scrambled_table(rng, b, max_pages, [2 * PAGE] * b, n_pages)
    serving = _with(JPagedKVCache.create(1, n_pages, PAGE, KVH, D, b,
                                         max_pages, quantized=quantized),
                    table=table)
    slots, lens = [2, 0], [t, t - 2]
    js = serving
    for i, (slot, n) in enumerate(zip(slots, lens)):
        js = js.insert_sequence(jg, slot, n, src_slot=i)
    want = _pools(js)
    for how in ("group", "sequence"):
        pc = _port_cache(serving)
        if how == "group":
            pc.insert_group(_port_cache(jg), slots, lens)
        else:
            for i, (slot, n) in enumerate(zip(slots, lens)):
                pc.insert_sequence(_port_cache(jg), slot, n, src_slot=i)
        assert torch.equal(pc.pools[0], want[0]), how
        if quantized:
            assert torch.equal(pc.scales[0], want[1]), how
        np.testing.assert_array_equal(pc.lengths.numpy(),
                                      np.asarray(js.lengths))


# -- P3 / P3i / grid: paged decode attention ----------------------------------

ATTN_CASES = {  # name: (batch, group, quantized, lengths)
    "grouped_f32": (4, 2, False, [PAGE + 2, 3 * PAGE, 1, 2 * PAGE]),
    "grouped_f32_g4": (8, 4, False, [1, PAGE, 3 * PAGE - 1, 2 * PAGE + 1,
                                     4 * PAGE, 5, PAGE + 1, 2 * PAGE]),
    "grid_f32": (3, 0, False, [1, 2 * PAGE, 3 * PAGE - 1]),
    "grouped_int8": (4, 2, True, [21, 5, 2 * PAGE, 1]),
}


def _attn_case(name, unmapped_inside=False):
    b, group, quantized, lengths = ATTN_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    h, max_pages, n_pages = 4, 4, 40             # GQA: 2 heads per kv head
    table = _scrambled_table(rng, b, max_pages, lengths, n_pages)
    if unmapped_inside:
        table[1, 1] = -1                         # inside lengths[1]
    jc = JPagedKVCache.create(1, n_pages, PAGE, KVH, D, b, max_pages,
                              quantized=quantized)
    if quantized:
        # Fill the mapped pages through the reference's prefill.
        full = max_pages * PAGE
        k, v = (rng.standard_normal((b, KVH, full, D)).astype(np.float32)
                for _ in range(2))
        jc = _with(jc, table=table).append(0, jnp.asarray(k),
                                           jnp.asarray(v), position=0)
    else:
        pool = rng.standard_normal((n_pages, PAGE, 2, F)).astype(np.float32)
        jc = JPagedKVCache([jnp.asarray(pool)], jnp.asarray(table),
                           jc.lengths, PAGE, KVH, D)
    jc = _with(jc, lengths=lengths)
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    return jc, _port_cache(jc), q, group


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_paged_attention_plain_matches_reference(name):
    """``decode_attn_paged_plain`` against ``flash_decode_paged_grouped``
    (float, groups 2 and 4), ``decode_attn_paged_grid_plain`` against
    ``flash_decode_paged`` (batch 3, no group) and
    ``decode_attn_paged_int8_plain`` against the grouped int8 mode, over
    scrambled pages, GQA, lengths 1 through whole pages, at the
    reference's tolerances."""
    jc, pc, q, group = _attn_case(name)
    args = (jnp.asarray(q), jc.pools[0], jc.page_table, jc.lengths, KVH)
    tq, pool, table, lengths = _t(q), pc.pools[0], pc.page_table, pc.lengths
    if name.startswith("grid"):
        ref = flash_decode_paged(*args)
        out = at.decode_attn_paged_grid(tq, pool, table, lengths)
    elif pc.quantized:
        ref = flash_decode_paged_grouped(*args, group=group,
                                         kv_scales=jc.quant_scales[0])
        out = at.decode_attn_paged_int8(tq, pool, pc.scales[0], table,
                                        lengths)
    else:
        ref = flash_decode_paged_grouped(*args, group=group)
        out = at.decode_attn_paged(tq, pool, table, lengths)
    tol = INT8_TOL if pc.quantized else FLOAT_TOL
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_unmapped_page_inside_length_follows_each_reference():
    """The two reference kernels differ on an unmapped page inside a
    sequence's length (only a released slot has one): the grouped kernel
    reads pool page 0 (attention.py:2086-2087), the grid kernel masks the
    page (:2542,2553). Each port wrapper follows its own reference."""
    jc, pc, q, _ = _attn_case("grouped_f32", unmapped_inside=True)
    args = (jnp.asarray(q), jc.pools[0], jc.page_table, jc.lengths, KVH)
    pargs = (_t(q), pc.pools[0], pc.page_table, pc.lengths)
    grouped = at.decode_attn_paged(*pargs).numpy()
    grid = at.decode_attn_paged_grid(*pargs).numpy()
    np.testing.assert_allclose(
        grouped, np.asarray(flash_decode_paged_grouped(*args, group=2)),
        rtol=FLOAT_TOL, atol=FLOAT_TOL)
    np.testing.assert_allclose(grid, np.asarray(flash_decode_paged(*args)),
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    assert np.abs(grouped[1] - grid[1]).max() > 1e-3
    np.testing.assert_array_equal(grouped[0], grid[0])


# -- the allocator ------------------------------------------------------------

def test_allocator_alloc_release():
    """Page 0 is the reserved garbage page: never allocated."""
    alloc = PagedKVCache.make_allocator(4)
    assert sorted(alloc.alloc() for _ in range(3)) == [1, 2, 3]
    with pytest.raises(MemoryError):
        alloc.alloc()
    alloc.release([2, -1])
    assert alloc.alloc() == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedKVCache.make_allocator(8, partitions=2)


def test_ensure_capacity_and_release_slot():
    """Mapping pages for a slot on the host mirror, idempotently; the
    device table changes on upload only; exhaustion and outgrowing the
    table raise MemoryError; ``release_slot`` returns the pages, unmaps
    the row and sets the slot's length to 0."""
    cache = PagedKVCache.create(1, 6, PAGE, KVH, D, 2, 4, device="cpu")
    alloc = PagedKVCache.make_allocator(cache.n_pages)
    alloc.ensure_capacity(cache, 0, PAGE + 1, 0)
    assert (cache.page_table.numpy() == -1).all()
    alloc.upload(cache)
    table = cache.page_table.numpy().copy()
    assert (table[0] >= 0).sum() == 2 and (table[1] >= 0).sum() == 0
    alloc.ensure_capacity(cache, 0, PAGE + 1, 0)
    alloc.upload(cache)
    np.testing.assert_array_equal(cache.page_table.numpy(), table)
    alloc.ensure_capacity(cache, 1, 2, 2 * PAGE - 1)
    assert (alloc.table[1] >= 0).sum() == 3        # tokens 0..16
    alloc.upload(cache)
    np.testing.assert_array_equal(cache.page_table.numpy(), alloc.table)
    with pytest.raises(MemoryError):
        alloc.ensure_capacity(cache, 0, cache.capacity + PAGE, 0)
    cache = cache.with_lengths([PAGE + 1, 2 * PAGE - 1])
    alloc.release_slot(cache, 1)
    alloc.upload(cache)
    assert cache.lengths.tolist() == [PAGE + 1, 0]
    assert (cache.page_table.numpy()[1] == -1).all()
    mapped = [p for p in cache.page_table.numpy()[0] if p >= 0]
    assert sorted(alloc.free + mapped) == [1, 2, 3, 4, 5]
    with pytest.raises(MemoryError, match="exhausted"):
        alloc.ensure_capacity(cache, 1, cache.capacity, 0)


# -- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX and port models with the same f32 weights (seed 3) and the
    same int8 weights quantized from them."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**CFG))
    jp = jm.init_params(jax.random.PRNGKey(3))
    jq = jtr.quantize_weights(jp)
    pm = TransformerLM(TransformerConfig.tiny_test(**CFG))
    return (jm, pm, {"f32": jp, "int8": jq},
            {"f32": params_from_numpy(_np_tree(jp), device="cpu"),
             "int8": params_from_numpy(_np_tree(jq), device="cpu")})


@pytest.mark.parametrize("weights,b", [("f32", 4), ("f32", 3), ("int8", 4),
                                       ("int8", 3)])
def test_paged_decode_logits_match_reference(models, weights, b):
    """Teacher-forced decode on a paged cache from a prefilled group cache
    (identity table), at ragged depths that cross pages: every step's
    logits against the JAX package's — an f32 pool with f32 weights
    (batch 4: the grouped kernel; batch 3: the grid kernel) and an int8
    pool with int8 weights (batch 4: the grouped int8 kernel; batch 3:
    the gathered reference)."""
    jm, pm, jps, pps = models
    jp, pp = jps[weights], pps[weights]
    quantized = weights == "int8"
    tol = LOGIT_TOL if quantized else F32_LOGIT_TOL
    p, cap = 5, 32
    n_pages = b * cap // PAGE
    rng = np.random.default_rng(8)
    tokens = rng.integers(1, 128, (b, p))
    jc = jm.new_paged_cache(b, cap, PAGE, n_pages, identity_table=True,
                            quantized=quantized)
    pc = pm.new_paged_cache(b, cap, PAGE, n_pages, identity_table=True,
                            quantized=quantized, device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(tokens, jnp.int32), jc)
    pl, pc = pm.prefill(pp, torch.from_numpy(tokens), pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    lens = np.resize(np.array([p, 3, 1, p - 1], np.int32), b)
    jc, pc = jc.with_lengths(jnp.asarray(lens)), pc.with_lengths(lens)
    tok = rng.integers(1, 128, b)
    worst = 0.0
    for _ in range(12):                    # depths 1..17 cross two pages
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pp, torch.tensor(tok), pc)
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    print(f"{weights} batch {b}: worst logit difference {worst:.3e}")
    assert worst < tol, worst


def test_paged_decode_dispatch_follows_the_reference(models, monkeypatch):
    """Which wrapper a paged decode step reaches (transformer.py:495-524):
    a batch with a group in (8, 4, 2) → the grouped kernel, float or int8;
    no group → the grid kernel for a float pool and the gathered reference
    (no kernel) for an int8 pool; ``decode_attn`` other than auto/grouped
    → as with no group."""
    _, _, _, pps = models
    calls = []
    for name in ("decode_attn_paged", "decode_attn_paged_int8",
                 "decode_attn_paged_grid", "attn_reference"):
        real = getattr(ptr, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(ptr, name, spy)

    def step(pm, weights, b):
        calls.clear()
        cache = pm.new_paged_cache(b, 32, PAGE, b * 4, identity_table=True,
                                   quantized=weights == "int8",
                                   device="cpu")
        pm.decode_step(pps[weights], torch.ones(b, dtype=torch.int64), cache)
        return set(calls)

    pm = TransformerLM(TransformerConfig.tiny_test(**CFG))
    for b in (4, 8, 16):
        assert step(pm, "f32", b) == {"decode_attn_paged"}
        assert step(pm, "int8", b) == {"decode_attn_paged_int8"}
    for b in (1, 2, 3, 5):
        assert step(pm, "f32", b) == {"decode_attn_paged_grid"}
        assert step(pm, "int8", b) == {"attn_reference"}
    flat = TransformerLM(TransformerConfig.tiny_test(decode_attn="flat",
                                                     **CFG))
    assert step(flat, "f32", 4) == {"decode_attn_paged_grid"}


# -- the engine ---------------------------------------------------------------

PROMPTS = [[5, 17, 3, 9, 2, 11], [40, 41], [1, 2, 3], [9, 10, 11, 12, 13],
           [7], [60, 61, 62]]


def _engine_kw(max_batch, **kw):
    return dict(max_batch=max_batch, capacity=64, prefill_buckets=(8,),
                paged=True, page_size=8, **kw)


def _all_pages_returned(eng):
    eng.allocator.upload(eng.cache)
    assert sorted(eng.allocator.free) == list(range(1, eng.cache.n_pages))
    assert (eng.cache.page_table.numpy() == -1).all()


@pytest.mark.parametrize("max_batch", [2, 4])
def test_paged_engine_tokens_match_reference(models, max_batch):
    """Float pool, f32 weights, 6 prompts through ``max_batch`` slots (2:
    the grid kernel; 4: the grouped kernel), bursts of 3: the port's paged
    engine emits the JAX paged engine's tokens and the port's contiguous
    engine's, exactly, and every page returns to the pool."""
    jm, pm, jps, pps = models
    ref = JServingEngine(jm, jps["f32"], **_engine_kw(max_batch)).generate(
        PROMPTS, 10, burst=3)
    eng = ServingEngine(pm, pps["f32"], device="cpu", **_engine_kw(max_batch))
    out = eng.generate(PROMPTS, 10, burst=3)
    contiguous = ServingEngine(pm, pps["f32"], max_batch=max_batch,
                               capacity=64, prefill_buckets=(8,),
                               device="cpu").generate(PROMPTS, 10, burst=3)
    assert out == ref
    assert out == contiguous
    assert eng.stats()["completed"] == len(PROMPTS)
    _all_pages_returned(eng)


def test_paged_int8_engine_tokens_match_reference(models):
    """Int8 pool, int8 weights, max_batch 4 (the grouped int8 kernel):
    the port's tokens equal the JAX paged engine's wherever the
    reference's top-2 margin exceeds the int8 logit tolerance."""
    jm, pm, jps, pps = models
    kw = _engine_kw(4, quantized_cache=True)
    ref = JServingEngine(jm, jps["int8"], **kw).generate(PROMPTS, 10, burst=3)
    eng = ServingEngine(pm, pps["int8"], device="cpu", **kw)
    out = eng.generate(PROMPTS, 10, burst=3)
    assert eng._tail_flush == 0
    for prompt, r, o in zip(PROMPTS, ref, out):
        assert len(o) == len(r) == 10
        c = next((i for i in range(10) if r[i] != o[i]), 10)
        if c < 10:
            seq = jnp.asarray([prompt + r], jnp.int32)
            logits = np.asarray(jm.forward(jps["int8"], seq)[0][0])
            top = np.sort(logits[len(prompt) - 1 + c])
            assert top[-1] - top[-2] < LOGIT_TOL, (prompt, c)
    _all_pages_returned(eng)


def test_dead_slot_appends_go_to_garbage_page(models):
    """A finished slot keeps decoding until reused; with its table row
    unmapped its appends land in page 0, never in a live sequence's pages,
    so a live neighbour's tokens equal a solo run's (float and int8)."""
    _, pm, _, pps = models
    for weights in ("f32", "int8"):
        kw = _engine_kw(2, quantized_cache=weights == "int8")
        eng = ServingEngine(pm, pps[weights], device="cpu", **kw)
        eng.submit([1, 2, 3], max_new_tokens=2)
        r1 = eng.submit([4, 5, 6], max_new_tokens=20)
        solo = ServingEngine(pm, pps[weights], device="cpu", **kw)
        sr = solo.submit([4, 5, 6], max_new_tokens=20)
        solo.run(burst=4)
        eng.run(burst=4)
        assert r1.tokens == sr.tokens
        _all_pages_returned(eng)


def test_paged_pool_oversubscription(models):
    """A pool smaller than batch x capacity (6 pages for 2 slots of 8
    pages) serves short requests, and raises MemoryError only when a
    request truly needs more pages than are free."""
    _, pm, _, pps = models
    eng = ServingEngine(pm, pps["f32"], device="cpu",
                        **_engine_kw(2, pool_pages=6))
    outs = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=4, burst=2)
    assert all(len(t) == 4 for t in outs)
    _all_pages_returned(eng)
    with pytest.raises(MemoryError):
        eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=40, burst=4)


def test_cancel_releases_pages(models):
    """Cancelling a decoding request frees its slot and its pages, and
    the other request's tokens are unchanged."""
    _, pm, _, pps = models
    kw = _engine_kw(2)
    eng = ServingEngine(pm, pps["f32"], device="cpu", **kw)
    r0 = eng.submit([1, 2, 3], max_new_tokens=30)
    r1 = eng.submit([4, 5, 6], max_new_tokens=12)
    eng.step_burst(3)
    mapped = int((eng.allocator.table[0] >= 0).sum())
    free = len(eng.allocator.free)
    assert eng.cancel(r0) and not eng.cancel(r0)
    assert len(eng.allocator.free) == free + mapped
    eng.run(burst=3)
    solo = ServingEngine(pm, pps["f32"], device="cpu", **kw)
    assert r1.tokens == solo.generate([[4, 5, 6]], 12, burst=3)[0]
    assert eng.stats()["cancelled"] == 1
    _all_pages_returned(eng)


def test_paged_engine_refuses_a_tail_window(models):
    _, pm, _, pps = models
    with pytest.raises(ValueError, match="tail"):
        ServingEngine(pm, pps["int8"], device="cpu",
                      **_engine_kw(4, quantized_cache=True, tail_window=16))
