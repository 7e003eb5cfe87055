"""Host-side planning of the fused int8 head (K2, ``head_argmax_plan``) and
of the int8-dot int4 GEMM (Q1', ``int4_int8_plan``): the tiles cover every
row and column once, every K split is a whole number of groups, and the
scratch the wrappers allocate holds what the kernels write, at M from 1 to
1024. These run without a card; the wrappers' refusals are checked with the
dispatch forced to the kernel path, before any build or launch."""

import pytest
import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import gemm as pg
from rten_tpu_torch.kernels.quant import quantize_int4_words

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
