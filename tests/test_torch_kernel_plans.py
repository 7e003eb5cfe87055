"""Host-side planning of the fused int8 head (K2, ``head_argmax_plan``) and
of the weight-only int8 GEMM on its tiles (K4, ``matmul_int8_wo_plan``), of
the int8-dot int4 GEMM (Q1', ``int4_int8_plan``) and of the bf16-dot int4
GEMMs (Q1 and Q2, ``int4_bf16_plan``): the tiles cover every row and column
once, every K split is a whole number of groups, the tile follows M, and
the scratch the wrappers allocate holds what the kernels write, at M from 1
to 8192; and of the decode attention that serves a KV head's whole query
group in one block (the KV-group kernel: P3i and P3 with its grid mode,
``paged_plan``; G1, G2, K6, K8, A1 and K9 (separate K and V planes),
``rows_plan``; V1, ``verify_plan``: the S x rep (query, head) rows of a
verify chunk) over int8, bf16 and f32 rows: every live row in one chunk,
chunks of whole pages or units, the split count, the blocks and no
scratch, at batch 1-256 and groups 1-32, the paths' splits, and a tiling
the kernel builds; and the decode appends' and the flush's (K5, P1, K7,
P2 and K3: one kernel body over f32, bf16 and int8 caches) choice
between the wide and narrow instances. These run
without a card; the wrappers' refusals are checked with the dispatch
forced to the kernel path, before any build or launch."""

import math

import pytest
import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.kernels import gemm as pg
from rten_tpu_torch.kernels.quant import (quantize_int4_groupwise,
                                          quantize_int4_words)

ROWS = (1, 2, 3, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129,
        200, 255, 256, 257, 300, 511, 512, 513, 1000, 1024)

# GPT-2's padded LM head; a ragged small head.
HEADS = ((768, 50264), (80, 1000), (64, 8))

# TinyLlama's int4 weights (K, N); a ragged case; Mistral-7B's w_down.
INT4_SHAPES = ((2048, 2560), (2048, 2048), (2048, 5632), (5632, 2048),
               (2048, 32000), (384, 768), (14336, 4096))


@pytest.mark.parametrize("k,n", HEADS)
@pytest.mark.parametrize("m", ROWS)
def test_head_argmax_plan_covers_once_and_sizes_its_scratch(m, k, n):
    plan = pg.head_argmax_plan(m, k, n)
    rows, slab = plan["rows"], plan["slab"]
    # Every row in exactly one row block, every column in exactly one slab.
    assert (plan["row_blocks"] - 1) * rows < m <= plan["row_blocks"] * rows
    assert (plan["slabs"] - 1) * slab < n <= plan["slabs"] * slab
    assert slab >= 128 and slab % 64 == 0
    # The bf16 copy of x is padded to whole row blocks and K stages.
    assert plan["m_pad"] == plan["row_blocks"] * rows
    assert plan["k_pad"] % 64 == 0 and plan["k_pad"] - 64 < k <= plan["k_pad"]
    xb, part_val, part_idx = plan["sizes"]
    assert xb >= 2 * plan["m_pad"] * plan["k_pad"]
    assert part_val >= 4 * m * plan["slabs"]
    assert part_idx >= 4 * m * plan["slabs"]
    # A whole decode batch of up to 256 rows is one row block.
    assert plan["row_blocks"] == 1 or m > 256


def test_head_argmax_plan_grows_its_row_block_with_m():
    rows = [pg.head_argmax_plan(m, 768, 50264)["rows"] for m in ROWS]
    assert rows == sorted(rows) and rows[-1] == 256


# K4's rows: the admission groups of up to 64 rows, (G)'s verify head at
# 32, and the wgmma tile above 64.
WO_ROWS = tuple(m for m in ROWS if m <= 300)


@pytest.mark.parametrize("k", (80, 768, 2048))
@pytest.mark.parametrize("m", WO_ROWS)
def test_matmul_wo_plan_covers_once_without_partials(m, k):
    """K4 runs K2's tile at every M (the register tile up to 64 rows,
    wgmma above), covers every row and every column of GPT-2's padded head
    once, and its only scratch is the padded bf16 copy of x."""
    n = 50264
    plan = pg.matmul_int8_wo_plan(m, k, n)
    head = pg.head_argmax_plan(m, k, n)
    assert {key: plan[key] for key in plan if key != "sizes"} == \
        {key: head[key] for key in head if key != "sizes"}
    rows, slab = plan["rows"], plan["slab"]
    assert (plan["row_blocks"] - 1) * rows < m <= plan["row_blocks"] * rows
    assert (plan["slabs"] - 1) * slab < n <= plan["slabs"] * slab
    assert plan["cfg"] == (0 if m <= 32 else 1 if m <= 64 else
                           2 if m <= 128 else 3)
    # The store epilogue's 16-byte groups of 4 columns start inside a slab
    # and lie in range or out as a whole.
    assert slab % 4 == 0 and n % 8 == 0
    (xb,) = plan["sizes"]
    assert plan["k_pad"] % 64 == 0 and plan["k_pad"] - 64 < k <= plan["k_pad"]
    assert xb == 2 * plan["row_blocks"] * rows * plan["k_pad"]
    assert len(head["sizes"]) == 3


def test_matmul_wo_kernel_refuses_unpadded_columns(monkeypatch):
    """On CUDA (simulated) K4 reads W in 8-byte pieces: an N that is not a
    multiple of 8 raises before any build or launch."""
    _kernel_path(monkeypatch)
    before = pg.matmul_int8_wo.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        pg.matmul_int8_wo(torch.zeros((4, 64)),
                          torch.zeros((64, 100), dtype=torch.int8),
                          torch.ones(100))
    assert pg.matmul_int8_wo.launches == before


@pytest.mark.parametrize("k,n", INT4_SHAPES)
@pytest.mark.parametrize("m", ROWS)
def test_int4_int8_plan_splits_whole_groups(m, k, n):
    group = 128
    g = k // group
    plan = pg.int4_int8_plan(m, k, n, group, sm_count=132)
    bounds, splits = plan["bounds"], plan["splits"]
    # The kernel's split z covers groups [z G / splits, (z + 1) G / splits).
    assert bounds == [z * g // splits for z in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == g
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    assert all(1 <= s <= pg._Q1P_MAX_SPLIT_GROUPS for s in sizes)
    assert 1 <= splits <= pg._Q1P_MAX_SPLITS
    # Every output tile once: row tiles of 16 x ms rows, 256 columns.
    rows = 16 * plan["ms"]
    assert plan["ms"] == (1 if m <= 16 else 2)
    assert (plan["m_tiles"] - 1) * rows < m <= plan["m_tiles"] * rows
    assert plan["n_tiles"] * 256 == n
    # Scratch: xq in fragment order for every padded row, and the scales.
    xq, xscale = plan["sizes"]
    assert plan["m_pad"] == plan["m_tiles"] * rows
    assert xq >= plan["m_pad"] * k and xscale >= 4 * plan["m_pad"]


@pytest.mark.parametrize("splits", [1, 3, 5, 7, 16])
def test_int4_int8_plan_keeps_a_given_split_count(splits):
    plan = pg.int4_int8_plan(16, 2048, 2560, 128, 132, splits)
    assert plan["splits"] == splits
    assert plan["bounds"][-1] == 16 and len(plan["bounds"]) == splits + 1


def test_int4_int8_plan_fills_one_wave_at_decode():
    """At decode the split count stops where the blocks would need a
    second wave of two resident blocks per SM."""
    for k, n in INT4_SHAPES:
        plan = pg.int4_int8_plan(16, k, n, 128, 132)
        blocks = plan["m_tiles"] * plan["n_tiles"] * plan["splits"]
        fewest = -(-(k // 128) // pg._Q1P_MAX_SPLIT_GROUPS)
        assert blocks <= 2 * 132 or plan["splits"] == fewest


def _kernel_path(monkeypatch):
    monkeypatch.setattr(_build, "on_cpu", lambda name, *tensors: False)


def test_int4_int8_kernel_refuses_a_group_it_does_not_tile(monkeypatch):
    """On CUDA (simulated) Q1' takes groups that are multiples of its
    32-deep K step; a group of 16 raises before any build or launch."""
    _kernel_path(monkeypatch)
    w = torch.randn((128, 256), generator=torch.Generator().manual_seed(0))
    words, _ = quantize_int4_words(w)
    x = torch.randn((4, 128))
    before = pg.matmul_int4_words_int8.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        pg.matmul_int4_words_int8(x, words, torch.ones((8, 256)), group=16)
    assert pg.matmul_int4_words_int8.launches == before


def test_int4_int8_kernel_refuses_more_groups_than_its_splits_hold(
        monkeypatch):
    """More than 16 splits of 16 groups each: refused before any build."""
    _kernel_path(monkeypatch)
    k = 32 * 17 * 16
    words = torch.zeros((k // 4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="splits"):
        pg.matmul_int4_words_int8(torch.zeros((1, k)), words,
                                  torch.ones((k // 32, 256)), group=32)


def test_int4_int8_kernel_refuses_a_split_count_out_of_range(monkeypatch):
    _kernel_path(monkeypatch)
    w = torch.randn((256, 256), generator=torch.Generator().manual_seed(1))
    words, scales = quantize_int4_words(w)
    x = torch.randn((4, 256))
    with pytest.raises(ValueError, match="splits must lie"):
        pg._launch_int4_int8(x, words, scales, 128, splits=3)


# Q1 and Q2: TinyLlama's and Mistral-7B's int4 weights (K, N), one pack
# tile, and a ragged case.
INT4_BF16_SHAPES = ((2048, 2560), (2048, 2048), (2048, 5632), (5632, 2048),
                    (2048, 32000), (4096, 6144), (4096, 4096), (4096, 14336),
                    (14336, 4096), (4096, 32000), (512, 256), (384, 768))
INT4_BF16_ROWS = (1, 2, 5, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 127,
                  128, 129, 512, 1000, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("group", (64, 128))
@pytest.mark.parametrize("k,n", INT4_BF16_SHAPES)
@pytest.mark.parametrize("m", INT4_BF16_ROWS)
def test_int4_bf16_plan_covers_once_and_sizes_its_scratch(m, k, n, group):
    g = k // group
    plan = pg.int4_bf16_plan(m, k, n, group, sm_count=132)
    # The tile follows M: decode (bound by bytes) up to 64 rows.
    assert plan["tile"] == ("decode" if m <= 64 else "prefill")
    rows = plan["rows"]
    assert (plan["m_tiles"] - 1) * rows < m <= plan["m_tiles"] * rows
    assert plan["m_pad"] == plan["m_tiles"] * rows
    assert plan["n_tiles"] * 256 == n
    bounds, splits = plan["bounds"], plan["splits"]
    assert bounds == [z * g // splits for z in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == g
    assert all(b > a for a, b in zip(bounds, bounds[1:]))
    if plan["tile"] == "decode":
        assert plan["ms"] == (1 if m <= 16 else 2) and rows == 16 * plan["ms"]
        assert 1 <= plan["fewest"] <= splits <= min(g, 16)
        assert plan["smem"] <= pg._INT4_SMEM_LIMIT
        # The ring holds at least 2 stages of 4 k16 steps (or the whole
        # split), all of the longest split's where they fit beside a
        # second block on the SM.
        stages = -(-g // splits) * group // 64
        assert min(2, stages) <= plan["ring"] <= min(16, stages)
        assert (plan["ring"] == min(16, stages)
                or plan["smem"] + pg._INT4_STAGE > pg._INT4_SMEM_TWO)
        assert plan["sizes"] == ()       # no scratch: one launch
    else:
        assert rows == 128 and splits == 1
        xb, xsum = plan["sizes"]
        assert xb >= 2 * plan["m_pad"] * k and xsum >= 4 * plan["m_pad"] * g


@pytest.mark.parametrize("ring", [1, 2, 16])
@pytest.mark.parametrize("ms,splits", [(1, 1), (1, 2), (1, 16), (2, 1),
                                       (2, 5), (2, 16)])
def test_int4_decode_smem_holds_what_the_kernel_stages(ms, splits, ring):
    """The decode tile's shared memory: 1 KB to align the ring, 33
    barriers, the split's f32 scales, its f32 x rows with their pad, the
    chunk sums, the weight ring (64 K rows of 128 bytes a stage) and the
    cluster's push buffer."""
    k, group = 2048, 128
    gmax = -(-(k // group) // splits)
    rows, ks = 16 * ms, gmax * group
    need = (1024 + 33 * 8 + gmax * 256 * 4 + rows * (ks + 16) * 4
            + rows * (ks // 64) * 4 + ring * 64 * 128
            + (splits * -(-(rows * 64) // splits) * 16 if splits > 1 else 0))
    assert pg._int4_decode_smem(ms, gmax, group, splits, ring) >= need


@pytest.mark.parametrize("splits", [1, 3, 5, 7, 16])
def test_int4_bf16_plan_keeps_a_given_split_count(splits):
    plan = pg.int4_bf16_plan(16, 2048, 2560, 128, 132, splits)
    assert plan["tile"] == "decode" and plan["splits"] == splits
    assert plan["bounds"][-1] == 16 and len(plan["bounds"]) == splits + 1


def test_int4_bf16_plan_fills_one_wave_at_decode():
    """At decode the split count stops where the blocks would need a
    second wave of two resident blocks per SM, or at one batch a warp."""
    for k, n in INT4_BF16_SHAPES:
        plan = pg.int4_bf16_plan(16, k, n, 128, 132)
        blocks = plan["m_tiles"] * plan["n_tiles"] * plan["splits"]
        fewest = (plan["fewest"], plan["pair"])
        assert blocks <= 2 * 132 or plan["splits"] in fewest
        assert plan["splits"] * 256 <= -(-k // 256) * 256 \
            or plan["splits"] in fewest
        # Two blocks fit on an SM wherever some split count allows it.
        assert plan["pair"] is None or plan["smem"] <= pg._INT4_SMEM_TWO


def test_int4_bf16_plan_takes_the_prefill_tile_where_no_split_fits():
    """At decode M a K too long for 16 splits' shared memory takes the
    prefill tile, which streams x through a ring: nothing is refused."""
    k = 64 * 1024
    plan = pg.int4_bf16_plan(16, k, 256, 64, 132)
    assert plan["tile"] == "prefill" and plan["sizes"][0] >= 2 * 128 * k
    assert pg.int4_bf16_plan(16, 8192, 256, 64, 132)["tile"] == "decode"


@pytest.mark.parametrize("mode", ["words", "bytes"])
def test_int4_kernels_refuse_a_group_they_do_not_tile(monkeypatch, mode):
    """On CUDA (simulated) Q1 and Q2 take groups that are multiples of 64;
    a group of 32 raises before any build or launch."""
    _kernel_path(monkeypatch)
    w = torch.randn((128, 256), generator=torch.Generator().manual_seed(2))
    make = quantize_int4_words if mode == "words" else \
        quantize_int4_groupwise
    wrapper = pg.matmul_int4_words if mode == "words" else pg.matmul_int4
    packed, _ = make(w, group=32)
    before = wrapper.launches
    with pytest.raises(ValueError, match="multiple of 64"):
        wrapper(torch.randn((4, 128)), packed, torch.ones((4, 256)),
                group=32)
    assert wrapper.launches == before


@pytest.mark.parametrize("m,splits", [(16, 0), (16, 17), (16, 3),
                                      (100, 2)])
def test_int4_kernels_refuse_a_split_count_out_of_range(monkeypatch, m,
                                                         splits):
    """Decode splits outside [fewest, min(groups, 16)], and any split count
    but 1 on the prefill tile, raise before any build."""
    _kernel_path(monkeypatch)
    w = torch.randn((256, 256), generator=torch.Generator().manual_seed(3))
    words, scales = quantize_int4_words(w)
    before = pg.matmul_int4_words.launches
    with pytest.raises(ValueError, match="splits must lie"):
        pg._launch_int4(pg.matmul_int4_words, torch.randn((m, 256)), words,
                        scales, 128, splits=splits)
    assert pg.matmul_int4_words.launches == before


# -- P3i and G1: the KV-group kernel's plan (kernels/attention.py) ----------

GROUPS = (1, 2, 4, 8)
BATCHES = (1, 2, 3, 7, 16, 31, 64, 100, 256)


@pytest.mark.parametrize("unit", [1, 8, 16, 64])
@pytest.mark.parametrize("splits", range(1, 9))
def test_kv_group_chunks_hold_every_row_once(splits, unit):
    """Every live row lies in exactly one split's chunk, each non-empty
    chunk starts on a unit (a page for P3i) and holds whole units but for
    the last, at every length from 0 to 300 rows."""
    for n in range(0, 301):
        chunks = at.kv_group_chunks(n, splits, unit)
        assert len(chunks) == splits
        seen = [0] * n
        for c0, c1 in chunks:
            assert 0 <= c0 <= c1 <= n and (c0 == c1 or c0 % unit == 0)
            for t in range(c0, c1):
                seen[t] += 1
        assert seen == [1] * n
        full = [c1 - c0 for c0, c1 in chunks if c1 < n]
        assert all(x % unit == 0 for x in full)


def _built_tilings():
    """The (head_dim, heads a warp, head groups) the KV-group kernel
    builds, read from its source: {False: G1's, True: P3i's}."""
    import re
    text = (_build.CSRC / "decode_attn_kv_group.cuh").read_text()
    narrow, wide = text.split("if constexpr (kWide)")
    find = lambda t: {tuple(map(int, m)) for m in re.findall(
        r"^  +KV_GROUP_TILING\((\d+), (\d+), (\d+)\)$", t, re.M)}
    return {False: find(narrow), True: find(narrow) | find(wide)}


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_kv_group_plan_picks_a_tiling_the_kernel_builds(d):
    """For every group of 1-32 query heads the plan's heads a warp and
    head groups are a tiling the kernel builds (G1 at head_dim 64 and 128;
    P3i, P3 with its grid mode and K8 up to 256), hold at most 32 values a
    lane a warp, and the blocks of a KV head cover its group once, the last
    one padded at most."""
    built = _built_tilings()
    assert built[False] and built[True] > built[False]
    for rep in range(1, 33):
        plan = at.paged_plan(2, 2 * rep, 2, 16, 8, d)
        w, g = plan["heads_per_warp"], plan["head_groups"]
        assert (d, w, g) in built[True]
        rows = at.rows_plan(2, 2 * rep, 2, 64, d)
        assert (rows["heads_per_warp"], rows["head_groups"]) == (w, g)
        if d <= 128:
            assert (d, w, g) in built[False]
        assert w * d // 8 <= 32 and w * g <= (8 if d <= 128 else 4)
        chunks = -(-rep // (w * g))
        assert (chunks - 1) * w * g < rep <= chunks * w * g
        assert chunks == 1 or w * g == (8 if d <= 128 else 4)
        assert plan["blocks"] == 2 * 2 * chunks * plan["splits"]


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("b", BATCHES)
def test_paged_int8_plan_splits_whole_pages_and_sizes_nothing(b, group):
    """P3i: splits in [fewest, 8], blocks = B x KVH x head blocks x splits
    (one CUDA kernel a call, the splits merged in their cluster; the plan
    allocates nothing); a chunk of the longest live length holds at most
    KV_GROUP_MAX_IDS pages; a batch that fills the card is not split."""
    kvh = max(1, 12 // group)
    for page, max_pages in ((8, 64), (16, 4), (64, 8), (64, 64), (8, 2048)):
        for d in (64, 128, 192, 256):
            plan = at.paged_plan(b, kvh * group, kvh, page, max_pages,
                                      d)
            s = plan["splits"]
            assert plan["fewest"] <= s <= plan["most"] <= 8
            per = plan["heads_per_warp"] * plan["head_groups"]
            pairs = b * kvh * -(-group // per)
            assert plan["blocks"] == pairs * s
            assert plan["unit"] == page
            assert plan["warps"] == (
                8 if plan["blocks"] <= at.KV_GROUP_WIDE_BLOCKS else 4)
            for n in (0, 1, page - 1, page, page + 1, page * max_pages):
                for c0, c1 in at.kv_group_chunks(n, s, page):
                    assert -(-(c1 - c0) // page) <= at.KV_GROUP_MAX_IDS
            if pairs >= at.KV_GROUP_TARGET_BLOCKS:
                assert s == plan["fewest"]


def test_paged_int8_plan_at_the_paged_path_is_one_unsplit_launch():
    """Path (D): GPT-2 at batch 256, 12 heads of 64, pages of 64 over a
    capacity of 512: 3072 blocks, no split, one warp a head."""
    plan = at.paged_plan(256, 12, 12, 64, 8)
    assert (plan["splits"], plan["blocks"]) == (1, 3072)
    assert (plan["heads_per_warp"], plan["head_groups"]) == (1, 1)
    assert plan["warps"] == 4


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("b", BATCHES)
def test_grouped_int8_plan_splits_into_whole_units(b, group):
    kvh = 8 if group <= 4 else 4
    for cap in (16, 100, 1024, 4096):
        for d in (64, 128):
            plan = at.rows_plan(b, kvh * group, kvh, cap, d)
            s = plan["splits"]
            assert 1 <= s <= min(8, -(-cap // at.KV_GROUP_UNIT))
            per = plan["heads_per_warp"] * plan["head_groups"]
            pairs = b * kvh * -(-group // per)
            assert plan["blocks"] == pairs * s
            assert plan["unit"] == at.KV_GROUP_UNIT
            assert s == 1 or pairs * (s - 1) < at.KV_GROUP_TARGET_BLOCKS
            assert plan["warps"] == (
                8 if plan["blocks"] <= at.KV_GROUP_WIDE_BLOCKS else 4)


def test_grouped_int8_plan_at_mistral_splits_to_fill_the_card():
    """Path (H): 16 sequences x 8 KV heads = 128 pairs, split into 2
    chunks (256 blocks, at most two an SM, so 8 warps each); a warp serves
    2 of the group's 4 heads."""
    plan = at.rows_plan(16, 32, 8, 4096)
    assert (plan["splits"], plan["blocks"], plan["warps"]) == (2, 256, 8)
    assert (plan["heads_per_warp"], plan["head_groups"]) == (2, 2)
    assert at.kv_group_chunks(576, 2, 16) == [(0, 288), (288, 576)]
    assert at.kv_group_chunks(544, 2, 16) == [(0, 272), (272, 544)]


def _int8_pool(b, h, kvh, d, page=8, max_pages=4):
    pool = torch.zeros((b * max_pages + 1, page, 2, kvh * d),
                       dtype=torch.int8)
    scales = torch.ones((b * max_pages + 1, page, 2, kvh),
                        dtype=torch.bfloat16)
    table = torch.arange(1, b * max_pages + 1, dtype=torch.int32).reshape(
        b, max_pages)
    return (torch.zeros((b, h, d)), pool, scales, table,
            torch.full((b,), 5, dtype=torch.int32))


def _int8_cache(b, h, kvh, d):
    return (torch.zeros((b, h, d)),
            torch.zeros((b, 32, 2, kvh * d), dtype=torch.int8),
            torch.ones((b, 32, 2, kvh), dtype=torch.bfloat16),
            torch.full((b,), 5, dtype=torch.int32))


@pytest.mark.parametrize("h,kvh,d,paged", [
    (4, 4, 96, True), (4, 4, 96, False), (4, 4, 320, True),
    (4, 4, 192, False), (4, 4, 256, False), (32, 2, 256, False)])
def test_kv_group_kernels_refuse_a_shape_they_do_not_tile(monkeypatch, h,
                                                          kvh, d, paged):
    """On CUDA (simulated) P3i takes head_dim 64 to 256 in steps of 64 (as
    K6's kernel did) and G1 64 or 128 (as V1's did), in both score modes;
    anything else raises before any build. Any group size is taken."""
    _kernel_path(monkeypatch)
    what = f"head_dim {d} must be one of"
    if paged:
        before = at.decode_attn_paged_int8.launches
        with pytest.raises(ValueError, match=what):
            at.decode_attn_paged_int8(*_int8_pool(2, h, kvh, d))
        assert at.decode_attn_paged_int8.launches == before
        return
    before = dict(at.decode_attn_grouped_int8.mode_launches)
    for scores in (False, True):
        with pytest.raises(ValueError, match=what):
            at.decode_attn_grouped_int8(*_int8_cache(2, h, kvh, d),
                                        int8_scores=scores)
    assert at.decode_attn_grouped_int8.mode_launches == before


@pytest.mark.parametrize("h,kvh,d", [(32, 2, 64), (16, 1, 128),
                                     (24, 2, 192), (12, 1, 256)])
def test_kv_group_kernels_take_a_group_above_eight(monkeypatch, h, kvh, d):
    """Groups of 12 and 16 query heads pass every check and reach the
    build (here: no nvcc); P3i takes head_dim 192 and 256."""
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    with pytest.raises(RuntimeError, match="no build"):
        at.decode_attn_paged_int8(*_int8_pool(2, h, kvh, d))
    if d <= 128:
        for scores in (False, True):
            with pytest.raises(RuntimeError, match="no build"):
                at.decode_attn_grouped_int8(*_int8_cache(2, h, kvh, d),
                                            int8_scores=scores)


def _no_build(lib, symbol, signature):
    raise RuntimeError(f"no build: {lib}.{symbol}")


def test_kv_group_kernels_refuse_strided_or_unaligned_tensors(monkeypatch):
    _kernel_path(monkeypatch)
    q, pool, scales, table, lengths = _int8_pool(2, 4, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        at.decode_attn_paged_int8(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), pool, scales, table,
                                  lengths)
    kv = torch.zeros((2, 33, 2, 128), dtype=torch.int8)[:, 1:]
    with pytest.raises(ValueError, match="contiguous"):
        at.decode_attn_grouped_int8(torch.zeros((2, 4, 64)), kv,
                                    torch.ones((2, 32, 2, 2),
                                               dtype=torch.bfloat16),
                                    lengths)
    flat = torch.zeros(2 * 32 * 2 * 128 + 8, dtype=torch.int8)
    kv = flat[8:].view(2, 32, 2, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.decode_attn_grouped_int8(torch.zeros((2, 4, 64)), kv,
                                    torch.ones((2, 32, 2, 2),
                                               dtype=torch.bfloat16),
                                    lengths)


@pytest.mark.parametrize("splits,warps", [(0, None), (9, None), (1, 6)])
def test_kv_group_kernels_refuse_a_split_count_out_of_range(monkeypatch,
                                                            splits, warps):
    """A plan with splits outside [fewest, 8] or warps other than 4 or 8
    raises in the launchers before any build."""
    _kernel_path(monkeypatch)
    what = "splits must lie" if warps is None else "warps must be"
    plan = at.paged_plan(2, 4, 2, 8, 4, 64, splits, warps)
    with pytest.raises(ValueError, match=what):
        at._launch_paged_int8(*_int8_pool(2, 4, 2, 64), None, plan)
    plan = at.rows_plan(2, 4, 2, 32, 64, splits, warps)
    with pytest.raises(ValueError, match=what):
        at._launch_grouped_int8_rows(*_int8_cache(2, 4, 2, 64), False,
                                     None, plan=plan)


# -- P3, its grid mode and K8: the KV-group kernel over float rows ----------

@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("b", BATCHES)
def test_float_plans_split_into_whole_pages_or_units(b, group):
    """P3 (paged) and K8 (contiguous; the element type does not enter the
    plan): splits in [fewest, most] <= 8, blocks = B x KVH x head blocks x
    splits, and every live row in one chunk of whole pages (P3) or 16-row
    units (K8), at every length from 0 to the capacity."""
    kvh = max(1, 12 // group)
    for page, max_pages in ((8, 64), (64, 8), (16, 4)):
        cap = page * max_pages
        plans = [(at.paged_plan(b, kvh * group, kvh, page, max_pages, 64),
                  page, cap),
                 (at.rows_plan(b, kvh * group, kvh, cap, 64),
                  at.KV_GROUP_UNIT, cap)]
        for plan, unit, cap in plans:
            s = plan["splits"]
            assert plan["unit"] == unit
            assert plan["fewest"] <= s <= plan["most"] <= 8
            per = plan["heads_per_warp"] * plan["head_groups"]
            assert plan["blocks"] == b * kvh * -(-group // per) * s
            for n in range(0, cap + 1, max(1, cap // 50)):
                chunks = at.kv_group_chunks(n, s, unit)
                rows = [t for c0, c1 in chunks for t in range(c0, c1)]
                assert rows == list(range(n))
                assert all(c0 % unit == 0 for c0, c1 in chunks if c1 > c0)


def test_float_plans_at_their_paths():
    """(E): P3 at batch 256, 3072 blocks of 4 warps, no split; its grid
    mode at batch 3 splits (8 chunks of whole pages in one cluster); K8 at
    (I) and (I-bf16) one unsplit launch, at TinyLlama's shape (32 query
    heads over 4 KV heads, capacity 2048) 4 splits of 8 warps, a warp
    serving 4 of the group's 8 heads."""
    e = at.paged_plan(256, 12, 12, 64, 8, 64)
    assert (e["splits"], e["blocks"], e["warps"]) == (1, 3072, 4)
    grid = at.paged_plan(3, 12, 12, 64, 8, 64)
    assert grid["splits"] == 8 and grid["blocks"] == 288
    flat = at.rows_plan(256, 12, 12, 512, 64)
    assert (flat["splits"], flat["blocks"], flat["warps"]) == (1, 3072, 4)
    tiny = at.rows_plan(16, 32, 4, 2048, 64)
    assert (tiny["splits"], tiny["blocks"], tiny["warps"]) == (4, 256, 8)
    assert (tiny["heads_per_warp"], tiny["head_groups"]) == (4, 2)


# K6's shapes (batch, heads, KV heads, capacity) and its plan there
# (splits, blocks, warps, heads a warp, head groups): paths (A) and (C);
# batch 3, the reference's fused fallback (8 splits in one cluster);
# TinyLlama's float cache (32 query heads over 4 KV heads).
K6_PLANS = [((256, 12, 12, 512), (1, 3072, 4, 1, 1)),
            ((3, 12, 12, 512), (8, 288, 4, 1, 1)),
            ((16, 32, 4, 2048), (4, 256, 8, 4, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,want", K6_PLANS, ids=str)
def test_decode_attn_float_takes_rows_plan_at_its_shapes(monkeypatch, shape,
                                                         want, dtype):
    """K6 (``decode_attn_float``) launches the KV-group kernel in its exact
    mode (its own C entry) at rows_plan's launch: the table's splits,
    blocks and warps, 16-row units, and its tiling of heads; one launch
    counted."""
    b, h, kvh, cap = shape
    plan = at.rows_plan(b, h, kvh, cap, 64)
    assert (plan["splits"], plan["blocks"], plan["warps"],
            plan["heads_per_warp"], plan["head_groups"]) == want
    calls = _recorded(monkeypatch)
    # The cache is never touched here: torch.empty maps it lazily.
    kv = torch.empty((b, cap, 2, kvh * 64), dtype=dtype)
    before = at.decode_attn_float.launches
    at.decode_attn_float(torch.zeros((b, h, 64)), kv,
                         torch.full((b,), 100, dtype=torch.int32))
    (symbol, got), = calls
    assert symbol == "decode_attn_float"
    assert got[4:15] == (b, h, kvh, 64, cap, int(dtype == torch.bfloat16),
                         want[0], at.KV_GROUP_UNIT, want[3], want[4],
                         want[2])
    assert at.decode_attn_float.launches == before + 1


def _float_pool(b, h, kvh, d, page=8, max_pages=4):
    pool = torch.zeros((b * max_pages + 1, page, 2, kvh * d))
    table = torch.arange(1, b * max_pages + 1, dtype=torch.int32).reshape(
        b, max_pages)
    return (torch.zeros((b, h, d)), pool, table,
            torch.full((b,), 5, dtype=torch.int32))


def _float_cache(b, h, kvh, d, dtype=torch.float32):
    return (torch.zeros((b, h, d)),
            torch.zeros((b, 32, 2, kvh * d), dtype=dtype),
            torch.full((b,), 5, dtype=torch.int32))


FLOAT_WRAPPERS = ("decode_attn_paged", "decode_attn_paged_grid",
                  "decode_attn_flat_float", "decode_attn_float")
ROWS_WRAPPERS = ("decode_attn_flat_float", "decode_attn_float")


def _float_call(name, b, h, kvh, d, dtype=torch.float32):
    if name in ROWS_WRAPPERS:
        return lambda: getattr(at, name)(*_float_cache(b, h, kvh, d, dtype))
    return lambda: getattr(at, name)(*_float_pool(b, h, kvh, d))


@pytest.mark.parametrize("d", [96, 320])
@pytest.mark.parametrize("name", FLOAT_WRAPPERS)
def test_kv_group_float_kernels_refuse_a_head_dim_they_do_not_tile(
        monkeypatch, name, d):
    """On CUDA (simulated) P3, its grid mode, K8 and K6 take head_dim 64 to
    256 in steps of 64; anything else raises before any build."""
    _kernel_path(monkeypatch)
    wrapper = getattr(at, name)
    before = wrapper.launches
    with pytest.raises(ValueError, match=f"head_dim {d} must be one of"):
        _float_call(name, 2, 4, 2, d)()
    assert wrapper.launches == before


@pytest.mark.parametrize("h,kvh,d", [(32, 2, 64), (16, 1, 128),
                                     (24, 2, 192), (12, 1, 256),
                                     (4, 4, 64)])
@pytest.mark.parametrize("name,dtype", [
    (name, torch.float32) for name in FLOAT_WRAPPERS] + [
    (name, torch.bfloat16) for name in ROWS_WRAPPERS])
def test_kv_group_float_kernels_take_every_shape_k6_took(monkeypatch, name,
                                                         dtype, h, kvh, d):
    """Groups of 1, 12 and 16 query heads and head_dim 64 to 256, f32 (P3,
    grid) and f32 or bf16 (K8, K6), pass every check and reach the build
    (here: no nvcc)."""
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    with pytest.raises(RuntimeError, match="no build"):
        _float_call(name, 2, h, kvh, d, dtype)()


@pytest.mark.parametrize("splits,warps", [(0, None), (9, None), (1, 6)])
@pytest.mark.parametrize("name", FLOAT_WRAPPERS)
def test_kv_group_float_launchers_refuse_a_split_count_out_of_range(
        monkeypatch, name, splits, warps):
    """A plan with splits outside [fewest, most] or warps other than 4 or 8
    raises in the float launchers before any build."""
    _kernel_path(monkeypatch)
    what = "splits must lie" if warps is None else "warps must be"
    wrapper = getattr(at, name)
    before = wrapper.launches
    with pytest.raises(ValueError, match=what):
        if name in ROWS_WRAPPERS:
            plan = at.rows_plan(2, 4, 2, 32, 64, splits, warps)
            at._launch_rows_float(wrapper, *_float_cache(2, 4, 2, 64), None,
                                  plan)
        else:
            plan = at.paged_plan(2, 4, 2, 8, 4, 64, splits, warps)
            at._launch_paged(wrapper, *_float_pool(2, 4, 2, 64), None,
                             name.endswith("grid"), plan)
    assert wrapper.launches == before


@pytest.mark.parametrize("name", FLOAT_WRAPPERS)
def test_kv_group_float_launchers_refuse_strided_or_unaligned_tensors(
        monkeypatch, name):
    _kernel_path(monkeypatch)
    if name in ROWS_WRAPPERS:
        q, kv, lengths = _float_cache(2, 4, 2, 64)
        strided = torch.zeros((2, 33, 2, 128))[:, 1:]
        flat = torch.zeros(2 * 32 * 2 * 128 + 1)
        bf = torch.zeros(2 * 32 * 2 * 128 + 4, dtype=torch.bfloat16)
        cases = [((q, strided, lengths), "contiguous"),
                 ((q, flat[1:].view(2, 32, 2, 128), lengths),
                  "16-byte aligned"),
                 ((q, bf[4:].view(2, 32, 2, 128), lengths),
                  "16-byte aligned")]
        call = getattr(at, name)
    else:
        q, pool, table, lengths = _float_pool(2, 4, 2, 64)
        strided_q = q.transpose(0, 1).contiguous().transpose(0, 1)
        flat = torch.zeros(pool.numel() + 1)
        cases = [((strided_q, pool, table, lengths), "contiguous"),
                 ((q, flat[1:].view(pool.shape), table, lengths),
                  "16-byte aligned")]
        call = getattr(at, name)
    for args, what in cases:
        with pytest.raises(ValueError, match=what):
            call(*args)


# -- V1 and G2: the KV-group kernel over a verify chunk and for G2 -----------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("s", range(1, 9))
def test_verify_plan_covers_every_query_row_once(s, rep, d):
    """V1's blocks of a KV head serve each (query i, head h) pair of the
    chunk once, as row i * rep + h, with a tiling the kernel builds (at
    most 32 values a lane, 8 rows a block); blocks = B x KVH x row blocks
    x splits."""
    built = _built_tilings()[False]
    kvh, b = 2, 3
    plan = at.verify_plan(b, s, kvh * rep, kvh, 2048, d)
    w, g = plan["heads_per_warp"], plan["head_groups"]
    assert (d, w, g) in built and w * d // 8 <= 32 and w * g <= 8
    per, rows = w * g, s * rep
    chunks = -(-rows // per)
    seen = {}
    for c in range(chunks):
        for hl in range(min(per, rows - c * per)):   # the block's real rows
            pair = divmod(c * per + hl, rep)
            seen[pair] = seen.get(pair, 0) + 1
    assert seen == {(i, h): 1 for i in range(s) for h in range(rep)}
    assert chunks == 1 or per == 8
    assert plan["blocks"] == b * kvh * chunks * plan["splits"]
    assert plan["unit"] == at.KV_GROUP_UNIT


@pytest.mark.parametrize("s", range(1, 9))
@pytest.mark.parametrize("cap", [16, 40, 2048])
def test_verify_plan_chunks_cover_the_chunk_rows_once(cap, s):
    """Every row some query of the chunk reads, [0, min(len + S, cap)),
    lies in one split's chunk of whole 16-row units, at every length from
    0 to past the capacity and every split count the plan takes."""
    most = at.verify_plan(1, s, 12, 12, cap, 64)["most"]
    assert most == min(8, -(-cap // 16))
    for splits in range(1, most + 1):
        for live in range(0, cap + 3):
            n = min(live + s, cap)
            reads = max(min(live + i + 1, cap) for i in range(s))
            assert reads == n
            rows = [t for c0, c1 in at.kv_group_chunks(n, splits, 16)
                    for t in range(c0, c1)]
            assert rows == list(range(n))


def test_verify_plan_at_its_paths():
    """(G) and (G-int8): GPT-2-small at batch 8, S 4, 12 heads of 64,
    capacity 2048: 96 (sequence, KV head) pairs in 3 splits, a warp
    serving the 4 queries of a head; the fused entry's batch 3: 36 pairs in
    8 splits; S 5-8 take 8 query rows a block (4 x 2); Mistral-7B's GQA
    (32 heads over 8 of 128) at S 4: 16 rows a KV head in 2 blocks."""
    g = at.verify_plan(8, 4, 12, 12, 2048, 64)
    assert (g["splits"], g["blocks"]) == (3, 288)
    assert (g["heads_per_warp"], g["head_groups"]) == (4, 1)
    b3 = at.verify_plan(3, 4, 12, 12, 2048, 64)
    assert (b3["splits"], b3["blocks"]) == (8, 288)
    for s in range(5, 9):
        p = at.verify_plan(8, s, 12, 12, 2048, 64)
        assert (p["heads_per_warp"], p["head_groups"]) == (4, 2)
    m = at.verify_plan(16, 4, 32, 8, 4096, 128)
    assert m["heads_per_warp"] * m["head_groups"] == 8
    assert m["blocks"] == 16 * 8 * 2 * m["splits"]


def _verify_args(b=2, s=4, h=4, kvh=2, d=64, cap=32, int8=False):
    q = torch.zeros((b, s, h, d))
    if int8:
        kv = torch.zeros((b, cap, 2, kvh * d), dtype=torch.int8)
        scales = torch.ones((b, cap, 2, kvh), dtype=torch.bfloat16)
    else:
        kv, scales = torch.zeros((b, cap, 2, kvh * d)), None
    return q, kv, torch.full((b,), 5, dtype=torch.int32), scales


def _recorded(monkeypatch):
    """Simulated CUDA tensors and a C entry that records its arguments."""
    _kernel_path(monkeypatch)
    calls = []

    def function(lib, symbol, signature):
        return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    return calls


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("wrapper", ["verify_attn_grouped",
                                     "verify_attn_fused"])
def test_verify_wrappers_launch_the_plan(monkeypatch, wrapper, int8):
    """On CUDA (simulated) both V1 entries pass verify_plan's splits, unit,
    tiling and warps to the one C entry, with the cache's kind, and count
    one launch in their mode."""
    calls = _recorded(monkeypatch)
    fn = getattr(at, wrapper)
    before = (fn.launches, dict(fn.mode_launches))
    q, kv, lengths, scales = _verify_args(b=3, s=6, int8=int8)
    fn(q, kv, lengths, scales)
    plan = at.verify_plan(3, 6, 4, 2, 32, 64)
    (symbol, args), = calls
    assert symbol == "verify_attn"
    assert args[5:17] == (3, 6, 4, 2, 64, 32, 2 if int8 else 0,
                          plan["splits"], plan["unit"],
                          plan["heads_per_warp"], plan["head_groups"],
                          plan["warps"])
    key = "int8" if int8 else "float"
    assert fn.launches == before[0] + 1
    assert fn.mode_launches[key] == before[1][key] + 1


@pytest.mark.parametrize("s", [0, 9])
def test_verify_kernel_refuses_a_chunk_outside_one_to_eight(monkeypatch, s):
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    before = at.verify_attn_grouped.launches
    with pytest.raises(ValueError, match=f"S={s} outside 1..8"):
        at.verify_attn_grouped(*_verify_args(s=s))
    assert at.verify_attn_grouped.launches == before


@pytest.mark.parametrize("d", [32, 96, 192, 256])
@pytest.mark.parametrize("int8", [False, True])
def test_verify_kernel_refuses_a_head_dim_it_does_not_tile(monkeypatch, d,
                                                           int8):
    """V1 takes head_dim 64 or 128 (as before): anything else raises before
    any build; both take 64 and 128 to the build."""
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    with pytest.raises(ValueError, match=f"head_dim {d} must be one of"):
        at.verify_attn_fused(*_verify_args(d=d, int8=int8))
    for ok in (64, 128):
        with pytest.raises(RuntimeError, match="no build"):
            at.verify_attn_fused(*_verify_args(d=ok, int8=int8))


def test_verify_kernel_refuses_strided_or_unaligned_tensors(monkeypatch):
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    q, kv, lengths, scales = _verify_args(int8=True)
    strided_q = q.transpose(1, 2).contiguous().transpose(1, 2)
    strided_kv = torch.zeros((2, 33, 2, 128), dtype=torch.int8)[:, 1:]
    flat = torch.zeros(2 * 32 * 2 * 128 + 8, dtype=torch.int8)
    unaligned = flat[8:].view(2, 32, 2, 128)
    strided_scales = torch.ones((2, 32, 2, 4),
                                dtype=torch.bfloat16)[..., ::2]
    for args, what in (((strided_q, kv, lengths, scales), "contiguous"),
                       ((q, strided_kv, lengths, scales), "contiguous"),
                       ((q, kv, lengths, strided_scales), "contiguous"),
                       ((q, unaligned, lengths, scales), "16-byte aligned")):
        with pytest.raises(ValueError, match=what):
            at.verify_attn_grouped(*args)


@pytest.mark.parametrize("splits,warps", [(0, None), (9, None), (3, None),
                                          (1, 6)])
def test_verify_kernel_refuses_a_split_count_out_of_range(monkeypatch,
                                                          splits, warps):
    """A plan with splits outside [1, min(8, cap / 16)] (capacity 32: at
    most 2) or warps other than 4 or 8 raises before any build."""
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    what = "splits must lie" if warps is None else "warps must be"
    plan = at.verify_plan(2, 4, 4, 2, 32, 64, splits, warps)
    before = at.verify_attn_fused.launches
    with pytest.raises(ValueError, match=what):
        q, kv, lengths, scales = _verify_args()
        at._launch_verify(at.verify_attn_fused, q, kv, scales, lengths,
                          None, plan)
    assert at.verify_attn_fused.launches == before


def test_fused_int8_takes_rows_plan_at_h_fused(monkeypatch):
    """G2 at (H-fused) (batch 3, 32 heads over 8 KV heads of 128, capacity
    4096): G1's exact-q entry at rows_plan's launch, 24 pairs in 8 splits
    of 8 warps (192 blocks), a warp serving 2 of the group's 4 heads in 2
    groups; one launch counted on G2, none on G1."""
    calls = _recorded(monkeypatch)
    plan = at.rows_plan(3, 32, 8, 4096, 128)
    assert (plan["splits"], plan["blocks"], plan["warps"]) == (8, 192, 8)
    assert (plan["heads_per_warp"], plan["head_groups"]) == (2, 2)
    before = (at.decode_attn_fused_int8.launches,
              at.decode_attn_grouped_int8.launches)
    q = torch.zeros((3, 32, 128))
    kv = torch.zeros((3, 4096, 2, 1024), dtype=torch.int8)
    scales = torch.ones((3, 4096, 2, 8), dtype=torch.bfloat16)
    at.decode_attn_fused_int8(q, kv, scales,
                              torch.full((3,), 512, dtype=torch.int32))
    (symbol, args), = calls
    assert symbol == "decode_attn_grouped_int8_rows"
    assert args[6:17] == (3, 32, 8, 128, 4096, 0, 8, 16, 2, 2, 8)
    assert (at.decode_attn_fused_int8.launches,
            at.decode_attn_grouped_int8.launches) == (before[0] + 1,
                                                      before[1])


def test_fused_int8_refuses_strided_or_unaligned_tensors(monkeypatch):
    """G2 now checks what the KV-group kernel needs before any build: a
    strided or unaligned cache, at a ragged capacity too."""
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    q = torch.zeros((2, 4, 64))
    scales = torch.ones((2, 37, 2, 2), dtype=torch.bfloat16)
    lengths = torch.full((2,), 5, dtype=torch.int32)
    strided = torch.zeros((2, 38, 2, 128), dtype=torch.int8)[:, 1:]
    flat = torch.zeros(2 * 37 * 2 * 128 + 8, dtype=torch.int8)
    for kv, what in ((strided, "contiguous"),
                     (flat[8:].view(2, 37, 2, 128), "16-byte aligned")):
        with pytest.raises(ValueError, match=what):
            at.decode_attn_fused_int8(q, kv, scales, lengths)
    with pytest.raises(RuntimeError, match="no build"):
        at.decode_attn_fused_int8(q, flat[:-8].view(2, 37, 2, 128), scales,
                                  lengths)


# -- A1 on the KV-group kernel, the decode append fused -----------------------

def _append_args(b=2, h=4, kvh=2, d=64, cap=32, dtype=torch.float32,
                 width_pad=0, k_off=0, kv=None):
    """A1's arguments as the model passes them: q, the cache, and k and v
    as strided views of one qkv row [B, 1, (H + 2 KVH) D + width_pad], k
    starting ``k_off`` elements late."""
    f = kvh * d
    qkv = torch.zeros((b, 1, h * d + 2 * f + width_pad))
    k = qkv[..., h * d + k_off:h * d + f + k_off].reshape(
        b, 1, kvh, d).transpose(1, 2)
    v = qkv[..., h * d + f:h * d + 2 * f].reshape(b, 1, kvh, d).transpose(
        1, 2)
    if kv is None:
        kv = torch.zeros((b, cap, 2, f), dtype=dtype)
    return (torch.zeros((b, h, d)), kv, k, v,
            torch.full((b,), 5, dtype=torch.int32)), qkv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_append_takes_rows_plan_at_h_append(monkeypatch, dtype):
    """A1 at (H-append) (batch 16, 32 heads over 8 KV heads of 128, a
    cache of capacity 4096): the KV-group kernel at rows_plan's launch,
    128 pairs in 2 splits of 8 warps (256 blocks), a warp serving 2 of the
    group's 4 heads in 2 groups, G1's plan; k and v passed as the model's
    views of its qkv output (offsets H * D and (H + KVH) * D, row stride
    (H + 2 KVH) * D); one launch counted."""
    calls = _recorded(monkeypatch)
    plan = at.rows_plan(16, 32, 8, 4096, 128)
    assert (plan["splits"], plan["blocks"], plan["warps"]) == (2, 256, 8)
    assert (plan["heads_per_warp"], plan["head_groups"]) == (2, 2)
    # The cache is never touched here: torch.empty maps it lazily.
    kv = torch.empty((16, 4096, 2, 1024), dtype=dtype)
    args, qkv = _append_args(16, 32, 8, 128, 4096, kv=kv)
    before = at.decode_attn_grouped_append.launches
    at.decode_attn_grouped_append(*args)
    (symbol, got), = calls
    assert symbol == "decode_attn_append"
    assert got[8:19] == (16, 32, 8, 128, 4096, int(dtype == torch.bfloat16),
                         2, 16, 2, 2, 8)
    assert got[4:6] == (48 * 128, 48 * 128)
    assert (got[2] - qkv.data_ptr(), got[3] - qkv.data_ptr()) == (
        32 * 128 * 4, 40 * 128 * 4)
    assert at.decode_attn_grouped_append.launches == before + 1


def _unaligned(shape, dtype, elts=1):
    flat = torch.zeros(math.prod(shape) + elts, dtype=dtype)
    return flat[elts:].view(shape)


# (what, the arguments' overrides, plan overrides, the refusal's words).
APPEND_REFUSALS = [
    ("strided cache",
     dict(kv=torch.zeros((2, 33, 2, 128))[:, 1:]), {}, "contiguous"),
    ("unaligned f32 cache", dict(kv=_unaligned((2, 32, 2, 128),
                                               torch.float32)), {},
     "16-byte aligned"),
    ("unaligned bf16 cache", dict(kv=_unaligned((2, 32, 2, 128),
                                                torch.bfloat16)), {},
     "16-byte aligned"),
    ("new rows' pointer", dict(width_pad=4, k_off=1), {},
     "new rows must be 16-byte aligned"),
    ("new rows' stride", dict(width_pad=1), {},
     "new rows must be 16-byte aligned"),
    ("no split", {}, dict(splits=0), "splits must lie"),
    ("nine splits", {}, dict(splits=9), "splits must lie"),
    ("three splits of 16-row units at capacity 32", {}, dict(splits=3),
     "splits must lie"),
    ("six warps", {}, dict(warps=6), "warps must be"),
    ("head_dim 32", dict(d=32), {}, "head_dim"),
    ("head_dim 96", dict(d=96), {}, "head_dim"),
    ("head_dim 256", dict(d=256, h=2, kvh=1), {}, "head_dim"),
]


@pytest.mark.parametrize("case", APPEND_REFUSALS, ids=lambda c: c[0])
def test_grouped_append_refuses_before_any_build(monkeypatch, case):
    """On CUDA (simulated) A1 raises on what the KV-group kernel cannot
    take before any build or launch: a strided or unaligned cache, new
    rows whose pointer or row stride is not 16-byte aligned, a split count
    outside [1, min(8, cap / 16)], warps other than 4 or 8, head_dim other
    than 64 and 128."""
    _, overrides, plan_kw, what = case
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    args, _ = _append_args(**overrides)
    d = args[0].shape[2]
    before = at.decode_attn_grouped_append.launches
    with pytest.raises(ValueError, match=what):
        if plan_kw:
            at._launch_grouped_append(*args, None, at.rows_plan(
                2, 4, 2, 32, d, plan_kw.get("splits"), plan_kw.get("warps")))
        else:
            at.decode_attn_grouped_append(*args)
    assert at.decode_attn_grouped_append.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_append_takes_the_models_views(monkeypatch, dtype):
    """The control for the refusals above: the same shapes, aligned, reach
    the build."""
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    args, _ = _append_args(dtype=dtype)
    with pytest.raises(RuntimeError, match="no build"):
        at.decode_attn_grouped_append(*args)


# -- K7: the wide and narrow instances of the int8 decode append -------------

def _int8_append_args(b=3, kvh=2, d=64, width_pad=0, k_off=0, kv_off=0):
    """K7's arguments: an int8 cache (``kv_off`` bytes past a 16-byte
    boundary), k and v as strided views of one qkv row, and positions."""
    f, cap = kvh * d, 8
    qkv = torch.zeros((b, 1, 3 * f + width_pad))
    k = qkv[..., f + k_off:2 * f + k_off].reshape(b, 1, kvh, d).transpose(
        1, 2)
    v = qkv[..., 2 * f:3 * f].reshape(b, 1, kvh, d).transpose(1, 2)
    kv = _unaligned((b, cap, 2, f), torch.int8, 16 + kv_off)
    scales = torch.ones((b, cap, 2, kvh), dtype=torch.bfloat16)
    return kv, scales, k, v, torch.arange(b, dtype=torch.int32)


# (head_dim, layout overrides, the instance: True wide, False narrow).
K7_INSTANCES = [
    (32, {}, False), (64, {}, True), (96, {}, False), (128, {}, True),
    (256, {}, False), (160, {}, False), (192, {}, False), (224, {}, False),
    (16, {}, False), (80, {}, False), (8, {}, False), (3, {}, False),
    (288, {}, False), (512, {}, False),
    (64, dict(k_off=1, width_pad=4), False),     # a row's pointer
    (64, dict(width_pad=2), False),              # the row stride
    (128, dict(kv_off=8), False),                # the cache's pointer
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d,layout,wide", K7_INSTANCES, ids=str)
def test_kv_append_int8_picks_its_instance(monkeypatch, d, layout, wide,
                                           masked):
    """On CUDA (simulated) K7 passes the wide instance (16-byte loads) for
    head_dim 64 or 128 with every row 16-byte aligned, and the narrow one
    otherwise (any other head_dim, a multiple of 32 too); ``masked`` and
    the views' row strides as given; one launch counted."""
    calls = _recorded(monkeypatch)
    kv, scales, k, v, pos = _int8_append_args(d=d, **layout)
    assert kc.kv_append_wide(d, kv, k.reshape(3, -1),
                             v.reshape(3, -1)) == wide
    before = kc.kv_append_int8.launches
    kc.kv_append_int8(kv, scales, k, v, pos, masked=masked)
    (symbol, got), = calls
    assert symbol == "kv_append_int8"
    f = 2 * d
    assert got[2:4] == (3 * f + layout.get("width_pad", 0),) * 2
    assert got[7:13] == (3, 8, 2, d, int(masked), int(wide))
    assert kc.kv_append_int8.launches == before + 1


K7_REFUSALS = [
    ("strided cache", lambda a: (a[0].transpose(0, 1).contiguous()
                                 .transpose(0, 1), *a[1:]), "contiguous"),
    ("strided scales", lambda a: (a[0], torch.ones(
        (3, 8, 2, 4), dtype=torch.bfloat16)[..., ::2], *a[2:]),
     "contiguous"),
    ("strided positions", lambda a: (*a[:4], torch.zeros(
        6, dtype=torch.int32)[::2]), "contiguous"),
    ("scales of another shape", lambda a: (a[0], torch.ones(
        (3, 8, 2, 1), dtype=torch.bfloat16), *a[2:]), "scales must be"),
    ("rows of two tokens", lambda a: (*a[:2], torch.zeros((3, 2, 2, 64)),
                                      torch.zeros((3, 2, 2, 64)), a[4]),
     "k and v must be"),
]


@pytest.mark.parametrize("case", K7_REFUSALS, ids=lambda c: c[0])
def test_kv_append_int8_refuses_before_any_build(monkeypatch, case):
    """K7 raises on what neither instance takes before any build: strided
    cache, scales or positions, and shapes off its contract."""
    _, change, what = case
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    with pytest.raises(ValueError, match=what):
        kc.kv_append_int8(*change(_int8_append_args()))
    with pytest.raises(RuntimeError, match="no build"):
        kc.kv_append_int8(*_int8_append_args())


# -- P2: K7's kernel through the page table -----------------------------------

def _paged_int8_append_args(b=3, kvh=2, d=64, width_pad=0, k_off=0,
                            kv_off=0):
    """P2's arguments: an int8 pool of pages of 8 (``kv_off`` bytes past a
    16-byte boundary), its scales, k and v as strided views of one qkv
    row, a table of 2 pages a sequence and lengths."""
    f, page, max_pages = kvh * d, 8, 2
    qkv = torch.zeros((b, 1, 3 * f + width_pad))
    k = qkv[..., f + k_off:2 * f + k_off].reshape(b, 1, kvh, d).transpose(
        1, 2)
    v = qkv[..., 2 * f:3 * f].reshape(b, 1, kvh, d).transpose(1, 2)
    n_pages = b * max_pages + 1
    pool = _unaligned((n_pages, page, 2, f), torch.int8, 16 + kv_off)
    scales = torch.ones((n_pages, page, 2, kvh), dtype=torch.bfloat16)
    table = torch.arange(1, n_pages, dtype=torch.int32).reshape(b, max_pages)
    return pool, scales, k, v, table, torch.arange(b, dtype=torch.int32)


@pytest.mark.parametrize("d,layout,wide", K7_INSTANCES, ids=str)
def test_kv_append_paged_int8_picks_its_instance(monkeypatch, d, layout,
                                                 wide):
    """On CUDA (simulated) P2 runs K7's kernel and takes its instance by
    K7's rule: the wide one for head_dim 64 or 128 with the pool and every
    row 16-byte aligned, the narrow one otherwise; the views' row strides
    and the pool's shape as given; one launch counted."""
    calls = _recorded(monkeypatch)
    pool, scales, k, v, table, lengths = _paged_int8_append_args(d=d,
                                                                 **layout)
    assert kc.kv_append_wide(d, pool, k.reshape(3, -1),
                             v.reshape(3, -1)) == wide
    before = kc.kv_append_paged_int8.launches
    kc.kv_append_paged_int8(pool, scales, k, v, table, lengths)
    (symbol, got), = calls
    assert symbol == "kv_append_paged_int8"
    assert got[2:4] == (3 * 2 * d + layout.get("width_pad", 0),) * 2
    assert got[8:14] == (3, 8, 2, 2, d, int(wide))
    assert kc.kv_append_paged_int8.launches == before + 1


# -- K5 and P1: the float decode appends on K7's kernel body ------------------

def _float_append_args(dtype, d=64, width_pad=0, k_off=0, kv_off=0):
    """K5's arguments at K7's layouts (:func:`_int8_append_args`) on an f32
    or bf16 cache ``kv_off`` bytes past a 16-byte boundary."""
    kv, _, k, v, pos = _int8_append_args(d=d, width_pad=width_pad,
                                         k_off=k_off)
    size = torch.empty((), dtype=dtype).element_size()
    return _unaligned(kv.shape, dtype, (16 + kv_off) // size), k, v, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,layout,wide", K7_INSTANCES, ids=str)
def test_kv_append_picks_its_instance(monkeypatch, d, layout, wide, dtype):
    """On CUDA (simulated) K5 runs K7's kernel body and takes its instance
    by K7's rule on an f32 or a bf16 cache: the wide one for head_dim 64 or
    128 with the cache and every row 16-byte aligned, the narrow one
    otherwise; the views' row strides, the heads, head_dim and the cache's
    dtype as given; one launch counted."""
    calls = _recorded(monkeypatch)
    kv, k, v, pos = _float_append_args(dtype, d=d, **layout)
    assert kc.kv_append_wide(d, kv, k.reshape(3, -1),
                             v.reshape(3, -1)) == wide
    before = kc.kv_append.launches
    kc.kv_append(kv, k, v, pos)
    (symbol, got), = calls
    assert symbol == "kv_append"
    assert got[2:4] == (3 * 2 * d + layout.get("width_pad", 0),) * 2
    assert got[6:12] == (3, 8, 2, d, int(dtype == torch.bfloat16),
                         int(wide))
    assert kc.kv_append.launches == before + 1


@pytest.mark.parametrize("d,layout,wide", K7_INSTANCES, ids=str)
def test_kv_append_paged_picks_its_instance(monkeypatch, d, layout, wide):
    """On CUDA (simulated) P1 runs K7's kernel body through the page table
    and takes its instance by K7's rule on its f32 pool; the views' row
    strides and the pool's shape as given; one launch counted."""
    calls = _recorded(monkeypatch)
    pool, _, k, v, table, lengths = _paged_int8_append_args(d=d, **layout)
    pool = _unaligned(pool.shape, torch.float32,
                      (16 + layout.get("kv_off", 0)) // 4)
    assert kc.kv_append_wide(d, pool, k.reshape(3, -1),
                             v.reshape(3, -1)) == wide
    before = kc.kv_append_paged.launches
    kc.kv_append_paged(pool, k, v, table, lengths)
    (symbol, got), = calls
    assert symbol == "kv_append_paged"
    assert got[2:4] == (3 * 2 * d + layout.get("width_pad", 0),) * 2
    assert got[7:13] == (3, 8, 2, 2, d, int(wide))
    assert kc.kv_append_paged.launches == before + 1


# -- K3: the flush on the appends' kernel body --------------------------------

# (head_dim, window offset in elements, cache offset in bytes, the
# instance): wide at head_dim 64 and 128 on 16-byte aligned tensors,
# narrow at any other head_dim or on a window or cache off a 16-byte
# boundary.
FLUSH_INSTANCES = [(64, 0, 0, True), (128, 0, 0, True), (96, 0, 0, False),
                   (32, 0, 0, False), (256, 0, 0, False), (16, 0, 0, False),
                   (64, 1, 0, False), (64, 4, 0, False), (128, 8, 0, True),
                   (64, 0, 8, False), (128, 0, 16, True)]


@pytest.mark.parametrize("d,tail_off,kv_off,wide", FLUSH_INSTANCES,
                         ids=str)
def test_tail_flush_picks_its_instance(monkeypatch, d, tail_off, kv_off,
                                       wide):
    """On CUDA (simulated) K3 passes the wide instance (16-byte loads of
    bf16, 8- or 16-byte stores) for head_dim 64 or 128 with the window and
    the cache 16-byte aligned, and the narrow one otherwise; R, t and the
    shapes as given; one launch counted."""
    calls = _recorded(monkeypatch)
    b, rows, cap, kvh, t = 3, 16, 32, 2, 5
    tail = _unaligned((b, rows, 2, kvh * d), torch.bfloat16, 8 + tail_off)
    kv = _unaligned((b, cap, 2, kvh * d), torch.int8, 16 + kv_off)
    scales = torch.ones((b, cap, 2, kvh), dtype=torch.bfloat16)
    lengths = torch.full((b,), 9, dtype=torch.int32)
    assert kc.tail_flush_wide(d, tail, kv) == wide
    before = kc.tail_flush_int8.launches
    kc.tail_flush_int8(tail, kv, scales, lengths, t)
    (symbol, got), = calls
    assert symbol == "tail_flush_int8"
    assert got[4:11] == (b, rows, cap, kvh, d, t, int(wide))
    assert kc.tail_flush_int8.launches == before + 1


# -- K9 on the KV-group kernel over separate planes ---------------------------

# (B, H, KVH, head_dim, S) and K9's plan there (splits, blocks, warps,
# heads a warp, head groups): path (H)'s head shape at S 4096 (chip_smoke.py)
# and the card test's shapes (tests/test_torch_cuda.py).
K9_PLANS = [((16, 32, 8, 128, 4096), (2, 256, 8, 2, 2)),
            ((4, 8, 2, 128, 256), (8, 64, 8, 2, 2)),
            ((4, 8, 2, 256, 512), (8, 64, 8, 1, 4)),
            ((4, 32, 8, 128, 1024), (8, 256, 8, 2, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,want", K9_PLANS, ids=str)
def test_split_kv_takes_rows_plan_at_its_shapes(monkeypatch, shape, want,
                                                dtype):
    """K9 (``decode_attn_split_kv``) launches the KV-group kernel over its
    two planes at rows_plan's launch (S the capacity): the table's splits,
    blocks and warps, 16-row units and its tiling of heads; one launch
    counted."""
    b, h, kvh, d, s = shape
    plan = at.rows_plan(b, h, kvh, s, d)
    assert (plan["splits"], plan["blocks"], plan["warps"],
            plan["heads_per_warp"], plan["head_groups"]) == want
    calls = _recorded(monkeypatch)
    # The planes are never touched here: torch.empty maps them lazily.
    k, v = (torch.empty((b, kvh, s, d), dtype=dtype) for _ in range(2))
    before = at.decode_attn_split_kv.launches
    at.decode_attn_split_kv(torch.zeros((b, h, d)), k, v,
                            torch.full((b,), 100, dtype=torch.int32))
    (symbol, got), = calls
    assert symbol == "decode_attn_split_kv"
    assert got[1:3] == (k.data_ptr(), v.data_ptr())
    assert got[5:16] == (b, h, kvh, d, s, int(dtype == torch.bfloat16),
                         want[0], at.KV_GROUP_UNIT, want[3], want[4],
                         want[2])
    assert at.decode_attn_split_kv.launches == before + 1


K9_REFUSALS = [
    ("strided v", dict(v=torch.zeros((2, 2, 256, 256))[..., :128]),
     "contiguous"),
    ("unaligned k", dict(k=_unaligned((2, 2, 256, 128), torch.float32)),
     "16-byte aligned"),
    ("unaligned v", dict(v=_unaligned((2, 2, 256, 128), torch.float32)),
     "v_cache must be 16-byte aligned"),
    ("head_dim 384", dict(q=torch.zeros((2, 4, 384)),
                          k=torch.zeros((2, 2, 256, 384)),
                          v=torch.zeros((2, 2, 256, 384))),
     "head_dim 384"),
]


@pytest.mark.parametrize("what,args,match", K9_REFUSALS,
                         ids=[c[0] for c in K9_REFUSALS])
def test_split_kv_refuses_what_its_kernel_does_not_take(monkeypatch, what,
                                                        args, match):
    """On CUDA (simulated) K9 at a kernel shape refuses strided planes,
    planes off a 16-byte boundary and a head_dim other than 128 or 256,
    before any build or launch."""
    _kernel_path(monkeypatch)
    monkeypatch.setattr(_build, "function", _no_build)
    call = dict(q=torch.zeros((2, 4, 128)),
                k=torch.zeros((2, 2, 256, 128)),
                v=torch.zeros((2, 2, 256, 128)))
    call.update(args)
    before = at.decode_attn_split_kv.launches
    with pytest.raises(ValueError, match=match):
        at.decode_attn_split_kv(call["q"], call["k"], call["v"],
                                torch.full((2,), 9, dtype=torch.int32))
    assert at.decode_attn_split_kv.launches == before


# -- the block modes: native_dots and pv_int8 on the KV-group kernel ---------

# (batch, heads, KV heads, capacity, block, head_dim): chip_smoke.py's (C)
# (native_dots) and (H) (pv_int8) shapes, the card tests' capacity 384 with
# blocks shorter than, as long as and longer than a ring tile (one not a
# power of two), a block of 4 and a block of the whole capacity.
BLOCK_PLANS = [(256, 12, 12, 512, 64, 64), (16, 32, 8, 4096, 64, 128),
               (16, 32, 8, 4096, 128, 128), (96, 8, 2, 384, 48, 64),
               (96, 8, 1, 384, 96, 128), (96, 4, 4, 384, 32, 64),
               (4, 8, 2, 256, 4, 64), (2, 4, 1, 256, 256, 128),
               (3, 32, 8, 1024, 256, 128)]


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("shape", BLOCK_PLANS, ids=str)
def test_block_plans_put_no_block_across_a_split(shape, native):
    """block_plan's chunks are whole reference blocks counted from row 0 at
    every live length (the last one short), cover [0, n) once, and take at
    most as many splits as the capacity holds blocks (8 at most); with
    ``native`` (native_dots) one split, and a forced second one is
    refused."""
    b, h, kvh, cap, block, d = shape
    plan = at.block_plan(b, h, kvh, cap, block, d, native=native)
    assert plan["unit"] == block and plan["fewest"] == 1
    assert plan["most"] == (1 if native else
                            min(at.KV_GROUP_MAX_SPLITS, cap // block))
    assert 1 <= plan["splits"] <= plan["most"]
    if native:
        assert plan["splits"] == 1
    for n in [x for x in ROWS if x <= cap] + [0, cap]:
        chunks = at.kv_group_chunks(n, plan["splits"], block)
        assert chunks[0][0] == 0 and chunks[-1][1] == n
        for (c0, c1), (nxt, _) in zip(chunks, chunks[1:] + [(n, n)]):
            assert c0 % block == 0 or c0 == n
            assert c1 == nxt and (c1 % block == 0 or c1 == n)
    wide = at.block_plan(b, h, kvh, cap, block, d, splits=2,
                         native=native)
    if native or cap // block < 2:
        with pytest.raises(ValueError, match="splits must lie in"):
            at._check_kv_group("block", (torch.zeros(4), torch.zeros(4)),
                               wide)
    else:
        at._check_kv_group("block", (torch.zeros(4), torch.zeros(4)), wide)


# (batch, heads, KV heads, capacity, head_dim, native) and block_plan's
# (splits, blocks, warps) at block 64: chip_smoke.py's (C) and (H) shapes;
# pv_int8 at a tiling of 32 values a lane (two heads a warp at head_dim
# 128, four at 64: over 128 registers at 8 warps) with halved targets, at
# one of 16 values with rows_plan's.
BLOCK_CHOICES = [((256, 12, 12, 512, 64, True), (1, 3072, 4)),
                 ((16, 32, 8, 4096, 128, False), (1, 128, 8)),
                 ((4, 32, 8, 4096, 128, False), (4, 128, 8)),
                 ((16, 32, 4, 4096, 64, False), (2, 128, 8)),
                 ((16, 8, 8, 4096, 128, False), (2, 256, 8)),
                 ((16, 32, 8, 4096, 128, True), (1, 128, 8))]


@pytest.mark.parametrize("shape,want", BLOCK_CHOICES, ids=str)
def test_block_plan_choices(shape, want):
    """block_plan's splits and warps: native_dots one split by rows_plan's
    warp rule; pv_int8 at the tilings whose 8-warp blocks fit one an SM
    halves rows_plan's targets of blocks (so (H) takes one split of 8
    warps), elsewhere takes rows_plan's choice."""
    b, h, kvh, cap, d, native = shape
    plan = at.block_plan(b, h, kvh, cap, 64, d, native=native)
    assert (plan["splits"], plan["blocks"], plan["warps"]) == want
    w = plan["heads_per_warp"]
    if not native and w * d // 8 < 32:
        rows = at.rows_plan(b, h, kvh, cap, d)
        assert (plan["splits"], plan["warps"]) == (rows["splits"],
                                                   rows["warps"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block,cap", [(64, 512), (4, 2048), (12, 96),
                                       (96, 384), (2048, 2048)], ids=str)
def test_native_dots_takes_one_split_of_whole_blocks(monkeypatch, block, cap,
                                                     dtype):
    """On CUDA (simulated) native_dots passes block_plan's one split of
    whole blocks (unit = the block) on a bf16 cache, and K6's rows_plan on
    an f32 one, to its one C entry; every block the kernel before took
    (a multiple of 4, at most 512 a capacity) and more launch, one count
    a call."""
    b, h, kvh, d = 8, 8, 2, 64
    calls = _recorded(monkeypatch)
    q = torch.zeros((b, h, d))
    kv = torch.zeros((b, cap, 2, kvh * d), dtype=dtype)
    before = at.decode_attn_native_dots.launches
    at.decode_attn_native_dots(q, kv, torch.full((b,), 9, dtype=torch.int32),
                               block_k=block, group=2)
    (symbol, got), = calls
    bf16 = dtype == torch.bfloat16
    plan = (at.block_plan(b, h, kvh, cap, block, d, native=True) if bf16
            else at.rows_plan(b, h, kvh, cap, d))
    assert symbol == "decode_attn_native_dots"
    assert got[4:16] == (b, h, kvh, d, cap, int(bf16), plan["splits"],
                         plan["unit"], plan["heads_per_warp"],
                         plan["head_groups"], plan["warps"], 0.125)
    assert plan["unit"] == (block if bf16 else at.KV_GROUP_UNIT)
    assert plan["splits"] == 1 or not bf16
    assert at.decode_attn_native_dots.launches == before + 1


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("shape", BLOCK_PLANS[1:6], ids=str)
def test_pv_int8_takes_block_plan(monkeypatch, shape, int8_scores):
    """On CUDA (simulated) pv_int8 passes block_plan's launch (chunks of
    whole blocks) to G1's C entry with mode bit 1 set, and counts the
    launch in its mode."""
    b, h, kvh, cap, block, d = shape
    calls = _recorded(monkeypatch)
    kv = torch.zeros((b, cap, 2, kvh * d), dtype=torch.int8)
    scales = torch.ones((b, cap, 2, kvh), dtype=torch.bfloat16)
    mode = "pv_int8." + ("int8_scores" if int8_scores else "exact")
    before = at.decode_attn_grouped_int8.mode_launches[mode]
    at.decode_attn_grouped_int8(torch.zeros((b, h, d)), kv, scales,
                                torch.full((b,), 9, dtype=torch.int32),
                                int8_scores=int8_scores, pv_int8=True,
                                block_k=block, group=b // 2 or 1)
    (symbol, got), = calls
    plan = at.block_plan(b, h, kvh, cap, block, d)
    assert symbol == "decode_attn_grouped_int8_rows"
    assert got[5] is None
    assert got[6:18] == (b, h, kvh, d, cap, 2 + int8_scores, plan["splits"],
                         block, plan["heads_per_warp"], plan["head_groups"],
                         plan["warps"], 1.0 / math.sqrt(d))
    assert at.decode_attn_grouped_int8.mode_launches[mode] == before + 1


# (what, native_dots or pv_int8, arguments, the refusal's words or None
# where the wrapper must launch): outside the kernels' range each raises
# before any build, naming the limit; every block the kernels before took
# launches.
BLOCK_REFUSALS = [
    ("native head_dim 96", "native", dict(d=96), "head_dim 96"),
    ("native unaligned cache", "native", dict(unaligned=True),
     "16-byte aligned"),
    ("native block 4 at 2048", "native", dict(block=4, cap=2048), None),
    ("native block 2048", "native", dict(block=2048, cap=2048), None),
    ("native two splits", "native", dict(splits=2),
     "native_dots takes one split of whole blocks of 64 rows"),
    ("pv_int8 head_dim 256", "pv", dict(d=256), "head_dim 256"),
    ("pv_int8 block 2048", "pv", dict(block=2048, cap=2048),
     "pv_int8 block 2048: the kernel takes <= 1024"),
    ("pv_int8 unaligned cache", "pv", dict(unaligned=True),
     "16-byte aligned"),
    ("pv_int8 forced unit", "pv", dict(unit=16),
     "whole blocks of 64 rows, got a unit of 16"),
    ("pv_int8 block 4", "pv", dict(block=4, cap=64), None),
    ("pv_int8 block 256", "pv", dict(block=256, cap=1024), None),
    ("pv_int8 block 1024", "pv", dict(block=1024, cap=1024), None),
]


@pytest.mark.parametrize("what,kind,args,match", BLOCK_REFUSALS,
                         ids=[c[0] for c in BLOCK_REFUSALS])
def test_block_modes_refuse_only_outside_their_range(monkeypatch, what,
                                                     kind, args, match):
    b, h, kvh = 4, 8, 2
    d, block, cap = args.get("d", 64), args.get("block", 64), \
        args.get("cap", 256)
    calls = _recorded(monkeypatch)
    if match is not None:
        monkeypatch.setattr(_build, "function", _no_build)
    q = torch.zeros((b, h, d))
    lengths = torch.full((b,), 9, dtype=torch.int32)
    shape, elts = (b, cap, 2, kvh * d), 1 if args.get("unaligned") else 0
    if kind == "native":
        kv = _unaligned(shape, torch.bfloat16, elts)
        wrapper = at.decode_attn_native_dots
        call = lambda: at.decode_attn_native_dots(q, kv, lengths,
                                                  block_k=block, group=2)
        if "splits" in args:
            call = lambda: at._launch_native_dots(
                q, kv, lengths, block, None,
                at.block_plan(b, h, kvh, cap, block, d, args["splits"]))
    else:
        kv = _unaligned(shape, torch.int8, elts)
        scales = torch.ones((b, cap, 2, kvh), dtype=torch.bfloat16)
        wrapper = at.decode_attn_grouped_int8
        plan = (at.rows_plan(b, h, kvh, cap, d) if "unit" in args
                else None)
        call = lambda: at._launch_pv_int8(q, kv, scales, lengths, False,
                                          None, block, plan)
    before = wrapper.launches
    if match is None:
        call()
        assert len(calls) == 1 and wrapper.launches == before + 1
    else:
        with pytest.raises(ValueError, match=match):
            call()
        assert wrapper.launches == before


# -- the partials mode on the KV-group kernel ---------------------------------

@pytest.mark.parametrize("q_bf16", [False, True])
@pytest.mark.parametrize("b,h,kvh,cap,want", [
    (256, 12, 12, 512, (1, 4, 1, 1)), (16, 32, 4, 2048, (4, 8, 4, 2))])
def test_partials_launch_rows_plan_on_the_kv_group_entry(monkeypatch, b, h,
                                                          kvh, cap, want,
                                                          q_bf16):
    """On CUDA (simulated) decode_attn_int8_partials launches G1's C entry
    once, in partials mode (4 exact q, 5 q_bf16), at rows_plan's splits,
    unit, tiling and warps, with an output of D + 2 lanes a head and no
    scratch: at path (B)'s shape one unsplit block of 4 warps per
    (sequence, head), at TinyLlama's 4 splits of 8 warps, 8 heads a
    block."""
    calls = _recorded(monkeypatch)
    d = 64
    q = torch.zeros((b, h, d))
    kv = torch.zeros((b, cap, 2, kvh * d), dtype=torch.int8)
    scales = torch.ones((b, cap, 2, kvh), dtype=torch.bfloat16)
    lengths = torch.full((b,), 9, dtype=torch.int32)
    before = at.decode_attn_int8_partials.launches
    out = at.decode_attn_int8_partials(q, kv, scales, lengths, q_bf16)
    assert out.shape == (b, h, d + 2)
    plan = at.rows_plan(b, h, kvh, cap, d)
    assert (plan["splits"], plan["warps"], plan["heads_per_warp"],
            plan["head_groups"]) == want
    (symbol, args), = calls
    assert symbol == "decode_attn_grouped_int8_rows" and args[5] is None
    assert args[6:17] == (b, h, kvh, d, cap, 5 if q_bf16 else 4,
                          plan["splits"], plan["unit"],
                          plan["heads_per_warp"], plan["head_groups"],
                          plan["warps"])
    assert at.decode_attn_int8_partials.launches == before + 1


# -- M1: the wgmma int8 GEMM ---------------------------------------------------

# GPT-2-small's linears (K, N): QKV, O, MLP up, MLP down; ragged shapes
# (the masked loader); a K of one tile and one short of two.
M1_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768),
             (33, 65), (1100, 520), (40, 130), (128, 16), (255, 64))
M1_ROWS = ROWS + (2047, 2048, 4095, 4096)


@pytest.mark.parametrize("k,n", M1_SHAPES)
@pytest.mark.parametrize("m", M1_ROWS)
def test_matmul_int8_plan_covers_once(m, k, n):
    """M1's output tiles cover every row and column once, its K splits
    every K tile once, each a nonempty range of whole 128-deep tiles, at
    most 8 a cluster, a power of two of them, each of at least 4 K tiles;
    a split launch (a block a tile) fits one wave of one block an SM, an
    unsplit one takes at most a block an SM, each walking tiles in turn;
    the loader is TMA exactly where K and N are multiples of 16."""
    plan = pg.matmul_int8_plan(m, k, n)
    bn, splits = plan["bn"], plan["splits"]
    assert bn in (64, 128)
    assert (plan["m_tiles"] - 1) * pg.M1_ROWS < m <= plan["m_tiles"] * 128
    assert (plan["n_tiles"] - 1) * bn < n <= plan["n_tiles"] * bn
    assert (plan["k_tiles"] - 1) * pg.M1_DEPTH < k <= plan["k_tiles"] * 128
    # The K tiles [t0, t1) of each split, as matmul_int8.cu computes them.
    ranges = [(z * plan["k_tiles"] // splits,
               (z + 1) * plan["k_tiles"] // splits) for z in range(splits)]
    assert 1 <= splits <= min(8, plan["k_tiles"])
    assert ranges[0][0] == 0 and ranges[-1][1] == plan["k_tiles"]
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    assert splits & (splits - 1) == 0
    assert splits == 1 or min(b - a for a, b in ranges) >= 4
    tiles = plan["m_tiles"] * plan["n_tiles"]
    assert plan["tiles"] == tiles
    assert plan["workers"] == (tiles if splits > 1
                               else min(tiles, pg.H100_SMS))
    assert plan["blocks"] == plan["workers"] * splits
    assert plan["blocks"] <= pg.H100_SMS or splits == 1
    assert bn == 64 or tiles >= pg.H100_SMS
    assert plan["loader"] == ("tma" if k % 16 == 0 and n % 16 == 0
                              else "regs")


def test_matmul_int8_plan_at_gpt2_linears():
    """At M 256 (a decode step at batch 256) GPT-2's linears take 64-column
    tiles, a block a tile; down (24 K tiles) splits K over 4 blocks of a
    cluster (96 blocks), the others run unsplit (O's 6 K tiles are too few
    to split); at M 4096 every linear takes 128-column tiles, unsplit, on
    132 blocks that walk the tiles in turn."""
    got = [(p["bn"], p["splits"], p["blocks"]) for p in
           (pg.matmul_int8_plan(256, k, n) for k, n in M1_SHAPES[:4])]
    assert got == [(64, 1, 72), (64, 1, 24), (64, 1, 96), (64, 4, 96)]
    for k, n in M1_SHAPES[:4]:
        plan = pg.matmul_int8_plan(4096, k, n)
        assert (plan["bn"], plan["splits"], plan["loader"],
                plan["blocks"]) == (128, 1, "tma", 132)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (nibble i of s) & 7
    of the 8-byte value y:x."""
    v = (y << 32) | x
    return sum(((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _swz(r, c):
    """wgmma.cuh's swz: the 16-byte chunk c of row r of a 128-byte
    swizzled tile."""
    return (r >> 3) * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4)


def _raw_off(bn, r, n):
    """matmul_int8.cu's raw_off: element (k row r, column n) of the raw W
    tile as the tensor map writes it."""
    if bn == 128:
        return r * 128 + (((n >> 4) ^ (r & 7)) << 4) + (n & 15)
    return r * bn + n


def _transposed_tile(tile, bn):
    """The W tile [128 k][bn n] through matmul_int8.cu's transposer: the
    raw tile at raw_off, each unit (16 k rows x 4 columns) loaded as 16
    words, rotated by (quad / 2) % 4 bytes, 4 x 4-transposed by the
    kernel's byte permutes and stored at swz(column, chunk). Returns the
    B tile's bytes, how often each byte was written, and the 16-byte slot
    (address bits 4-6) of every store and the 4-byte bank of every load,
    per warp instruction."""
    raw = bytearray(128 * bn)
    for r in range(128):
        for n in range(bn):
            raw[_raw_off(bn, r, n)] = tile[r][n]
    out = bytearray(bn * 128)
    written = [0] * (bn * 128)
    quads, stores, loads = bn // 4, {}, {}
    for u in range((128 // 16) * quads):
        t, it = u % 128, u // 128
        c, q = u // quads, u % quads
        rot = (q >> 1) & 3
        sel = (0x32103210 >> (4 * rot)) & 0xFFFF
        r = []
        for j in range(16):
            off = _raw_off(bn, 16 * c + j, 4 * q)
            loads.setdefault((t // 32, it, j), []).append(off // 4 % 32)
            r.append(_byte_perm(int.from_bytes(raw[off:off + 4], "little"),
                                0, sel))
        col = [[0] * 4 for _ in range(4)]
        for g in range(4):
            t0 = _byte_perm(r[4 * g], r[4 * g + 1], 0x5140)
            t1 = _byte_perm(r[4 * g + 2], r[4 * g + 3], 0x5140)
            t2 = _byte_perm(r[4 * g], r[4 * g + 1], 0x7362)
            t3 = _byte_perm(r[4 * g + 2], r[4 * g + 3], 0x7362)
            col[0][g] = _byte_perm(t0, t1, 0x5410)
            col[1][g] = _byte_perm(t0, t1, 0x7632)
            col[2][g] = _byte_perm(t2, t3, 0x5410)
            col[3][g] = _byte_perm(t2, t3, 0x7632)
        for j in range(4):
            n = 4 * q + ((j + rot) & 3)
            off = _swz(n, c)
            stores.setdefault((t // 8, it, j), []).append((off >> 4) & 7)
            for g in range(4):
                out[off + 4 * g:off + 4 * g + 4] = col[j][g].to_bytes(
                    4, "little")
                for i in range(4):
                    written[off + 4 * g + i] += 1
    return out, written, stores, loads


@pytest.mark.parametrize("bn", [64, 128])
def test_matmul_int8_transpose_gives_back_w_transposed(bn):
    """A Python mirror of M1's W-tile transpose and swizzle address maps:
    read at wgmma's K-major 128-byte swizzled map (element (n, k) at
    swz(n, k / 16) + k % 16), the B tile is Wᵀ byte for byte, every byte
    written once; the 8 lanes of each quarter-warp store into 8 distinct
    16-byte slots, and at bn 128 each warp's loads hit 32 distinct
    banks."""
    rng = torch.Generator().manual_seed(bn)
    tile = torch.randint(0, 256, (128, bn), generator=rng).tolist()
    out, written, stores, loads = _transposed_tile(tile, bn)
    assert written == [1] * (bn * 128)
    for n in range(bn):
        for k in range(128):
            assert out[_swz(n, k // 16) + k % 16] == tile[k][n]
    assert all(sorted(v) == list(range(8)) for v in stores.values())
    if bn == 128:
        assert all(len(set(v)) == 32 for v in loads.values())


@pytest.mark.parametrize("m,k,n,splits,match", [
    (256, 768, 768, None, None), (256, 768, 768, 6, None),
    (17, 33, 65, None, None), (256, 768, 768, 0, "splits"),
    (256, 768, 768, 7, "splits"), (64, 200, 64, 3, "splits")])
def test_matmul_int8_tiled_launches_its_plan(monkeypatch, m, k, n, splits,
                                             match):
    """On CUDA (simulated) M1 passes the plan's tile width, splits and
    loader to its C entry and counts one launch; a split count outside 1
    to min(8, K tiles) raises before any build."""
    calls = _recorded(monkeypatch)
    monkeypatch.setattr(pg, "_sm_count", lambda device: pg.H100_SMS)
    x = torch.zeros((m, k), dtype=torch.int8)
    w = torch.zeros((k, n), dtype=torch.int8)
    ws = torch.ones(n)
    plan = pg.matmul_int8_plan(m, k, n, splits=splits)
    before = pg.matmul_int8_tiled.launches
    if match:
        with pytest.raises(ValueError, match=match):
            pg._launch_int8_tiled(x, w, 0.5, ws, plan)
        assert not calls and pg.matmul_int8_tiled.launches == before
        return
    if splits is None:
        pg.matmul_int8_tiled(x, w, 0.5, ws)
    else:
        pg._launch_int8_tiled(x, w, 0.5, ws, plan)
    (symbol, args), = calls
    tma = int(plan["loader"] == "tma")
    assert symbol == "matmul_int8"
    assert args[5:12] == (m, n, k, plan["bn"], plan["splits"],
                          plan["workers"], tma)
    assert pg.matmul_int8_tiled.launches == before + 1
