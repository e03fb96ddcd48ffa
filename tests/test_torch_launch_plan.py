"""The launch plan of the kernels (``fused_lora``, ``sgmv_fused``, the
A-only ``matmul_rhs``, ``sgmv_rhs`` and the B-only ``matmul_out``,
``sgmv_out``): ``_cluster_plan`` in
``repro_torch/kernels/quant_matmul/kernel.py`` is pure Python, so its
guarantees are held here on the CPU: the blocks of a tile cover K and M
exactly once in whole quant groups of every side, the grid is whole
clusters, and a side's codes are copied 16 bytes at a time only where every
group start is 16-byte aligned."""

import math

import pytest

from repro_torch.kernels.quant_matmul.kernel import (CHUNK_COLS, MAX_CLUSTER,
                                                     OUT_BLOCKS, TILE_ROWS,
                                                     _cluster_plan, _per_word,
                                                     _smem_bytes)

SMEM = 232448      # an H100's opt-in shared memory per block (227 KB)


def _side(bits, group, ptr=0, rows=16, binary=None):
    """``(group, words_per_group, word_bytes, codes address mod 16, rank
    rows, binary)`` of a side (1-bit sides binary unless told otherwise)."""
    return (group, -(-group // _per_word(bits)), 4 if bits == 3 else 1, ptr,
            rows, bits == 1 if binary is None else binary)


def _plan(t, k, m, kt, groups, bits=(2, 2, 1, 1), x_bytes=2, rows=(16, 16),
          smem=SMEM):
    """The plan of one call; ``groups`` ``(ah, bh, al, bl)``, None for an
    absent side (bh None: an A-only call, m = 0; ah None: a B-only call,
    k = 0); ``rows`` the high and low sides' rank rows."""
    sides = tuple(None if g is None else _side(b, g, rows=rows[i // 2])
                  for i, (b, g) in enumerate(zip(bits, groups)))
    return _cluster_plan(t, k, m, kt, 0, x_bytes, 0, sides, smem), sides


def _slices(plan, dim, axis):
    """``[(start, stop)]`` columns of ``dim`` that each block of a cluster
    owns (the kernel's ``ku0 = rank·k_units``), empty for idle blocks."""
    unit, units = ((plan.k_unit, plan.k_units) if axis == "k"
                   else (plan.m_unit, plan.m_units))
    return [(min(dim, b * units * unit), min(dim, (b + 1) * units * unit))
            for b in range(plan.cluster)]


def _chunks(plan, dim, axis):
    """``[(start, stop)]`` columns of every staged chunk, block by block, as
    the kernel's loop ``for u in [ku0, ku1) step k_chunk`` stages them."""
    unit, units, chunk = ((plan.k_unit, plan.k_units, plan.k_chunk)
                          if axis == "k" else
                          (plan.m_unit, plan.m_units, plan.m_chunk))
    if units == 0:                       # an axis the call does not stage
        return [(0, 0)]
    nu = -(-dim // unit)
    out = []
    for b in range(plan.cluster):
        u0, u1 = b * units, min(nu, (b + 1) * units)
        out += [(u * unit, min(dim, min(u + chunk, u1) * unit))
                for u in range(u0, u1, chunk)]
    return out


def _check_cover(slices, dim, groups):
    """Slices in block order cover [0, dim) once; every non-empty slice
    starts on a group boundary of every side."""
    pos = 0
    for lo, hi in slices:
        assert lo == pos or (lo == hi == dim), (slices, dim)
        assert hi >= lo
        if hi > lo:
            assert all(lo % g == 0 for g in groups), (lo, groups)
        pos = max(pos, hi)
    assert pos == dim


SHAPES = [
    # t, k, m, kt (None: fused_lora picks the tile rows), groups ah bh al bl
    (16, 3072, 3072, 1, (128, 128, 128, 128)),
    (512, 3072, 1024, 8, (128, 128, 128, 128)),
    (16, 3072, 8192, 1, (128, 128, 128, 128)),
    (512, 8192, 3072, 8, (128, 128, 128, 128)),
    (16, 3072, 3072, None, (128, 128, 128, 128)),
    (512, 8192, 3072, None, (128, 128, 128, 128)),
    (13, 640, 192, None, (128, 64, 64, 128)),
    (1, 256, 200, None, (128, 128, None, None)),
    (30, 250, 198, 3, (64, 32, 32, 64)),
    (10, 100, 60, 2, (100, 60, 100, 60)),
    (6, 384, 256, 1, (32, 32, 16, 16)),
    (40, 65536, 32768, 8, (128, 128, 128, 128)),
    # mixtral-8x22b: folded expert rows at tile_t 1 (decode 64, prefill
    # 1280 dispatch rows), the router's M = 8 (B's groups of 8; blocks
    # 1-7 of its cluster own no M unit), and a prefill tile of the router
    (64, 6144, 6144, 1, (128, 128, 128, 128)),
    (1280, 6144, 1024, 1, (128, 128, 128, 128)),
    (64, 6144, 16384, 1, (128, 128, 128, 128)),
    (1280, 16384, 6144, 1, (128, 128, 128, 128)),
    (64, 6144, 8, 1, (128, 8, 128, 8)),
    (256, 6144, 8, 8, (128, 8, 128, 8)),
    # deepseek-v3-671b's nine LoRA linears at decode (16 one-row tiles)
    # and prefill (512 rows in tiles of 8): wq_up's K of 12 groups on an
    # 8-block cluster (blocks of 2 units, the last two idle), the
    # router's M = 256, K up to the dense wd's 18432
    *[(t, k, m, kt, (128, 128, 128, 128))
      for k, m in ((7168, 1536), (1536, 24576), (7168, 512), (16384, 7168),
                   (7168, 256), (7168, 2048), (2048, 7168), (7168, 18432),
                   (18432, 7168))
      for t, kt in ((16, 1), (512, 8))],
    # rwkv6-1.6b's and recurrentgemma-2b's seven distinct (K, M) at decode
    # and prefill: K = 7680 is 60 groups, 7.5 per block of the 8-block
    # cluster (the last block owns 4 units), recurrentgemma's M = 256 of
    # its single-KV-head wk / wv
    *[(t, k, m, kt, (128, 128, 128, 128))
      for k, m in ((2048, 2048), (2048, 7168), (7168, 2048), (2560, 2560),
                   (2560, 256), (2560, 7680), (7680, 2560))
      for t, kt in ((16, 1), (512, 8))],
    # A-only (matmul_rhs: kt None; sgmv_rhs: kt 1 / 3 / 8): m = 0, no B
    (16, 3072, 0, None, (128, None, None, None)),
    (512, 8192, 0, None, (128, None, None, None)),
    (13, 250, 0, None, (64, None, None, None)),
    (37, 100, 0, None, (100, None, None, None)),
    (16, 3072, 0, 1, (128, None, None, None)),
    (512, 8192, 0, 8, (128, None, None, None)),
    (39, 250, 0, 3, (32, None, None, None)),
    (24, 640, 0, 3, (100, None, None, None)),
    (64, 16384, 0, 8, (128, None, None, None)),
    # B-only (matmul_out: kt None; sgmv_out: kt 1 / 3 / 8): k = 0, no A
    (16, 0, 3072, None, (None, 128, None, None)),
    (512, 0, 8192, None, (None, 128, None, None)),
    (128, 0, 32768, None, (None, 128, None, None)),
    (13, 0, 200, None, (None, 128, None, None)),
    (16, 0, 1024, 1, (None, 128, None, None)),
    (512, 0, 3072, 8, (None, 128, None, None)),
    (39, 0, 198, 3, (None, 32, None, None)),
    (24, 0, 200, 3, (None, 100, None, None)),
]


# Rank rows of a call: a two-sided call's high and low sides share them
# equally (a rank-r adapter reaches the fused kernels with 2·rp rows), a
# one-sided call (rhs, out, or no low side) holds them all on one side
RANK_ROWS = (2, 8, 24, 32, 64, 72, 128, 256, 512)
BIT_WIDTHS = (1, 2, 3, 4, 8)


def _rank_plans(t, k, m, kt, groups, x_bytes=2):
    """The plan of one call at every rank-row count and bit width, with the
    sides as the plan saw them."""
    two = groups[2] is not None or groups[3] is not None
    for rows in RANK_ROWS:
        for bits in BIT_WIDTHS:
            hi = rows // 2 if two else rows
            plan, sides = _plan(t, k, m, kt, groups, bits=(bits,) * 4,
                                x_bytes=x_bytes, rows=(hi, rows - hi))
            yield rows, bits, plan, sides


@pytest.mark.parametrize("t,k,m,kt,groups", SHAPES)
def test_plan_slices_cover_k_and_m_exactly_once(t, k, m, kt, groups):
    """At every rank-row count from 2 to 512 and every bit width: the
    blocks' slices and their staged chunks cover K and M once in whole
    groups, and one block's shared-memory layout fits the budget."""
    a_groups = [g for g in (groups[0], groups[2]) if g]
    b_groups = [g for g in (groups[1], groups[3]) if g]
    x_bytes = 2 if k else 4
    for rows, bits, plan, sides in _rank_plans(t, k, m, kt, groups,
                                                x_bytes):
        assert plan.k_unit == math.lcm(*a_groups)
        assert plan.m_unit == math.lcm(*b_groups)
        for axis, dim, gs in (("k", k, a_groups), ("m", m, b_groups)):
            slices = _slices(plan, dim, axis)
            assert len(slices) == plan.cluster
            _check_cover(slices, dim, gs)
            _check_cover(_chunks(plan, dim, axis), dim, gs)
        # a staging chunk stays within CHUNK_COLS unless one unit is wider;
        # an A-only plan stages no M, a B-only plan no K
        for dim, unit, units, chunk in (
                (k, plan.k_unit, plan.k_units, plan.k_chunk),
                (m, plan.m_unit, plan.m_units, plan.m_chunk)):
            if units == 0:
                assert dim == 0 and chunk == 0 and unit == 1
                continue
            assert 1 <= chunk <= units
            assert chunk * unit <= max(CHUNK_COLS, unit)
        used = _smem_bytes(plan.tile_rows, x_bytes,
                           plan.k_chunk * plan.k_unit,
                           plan.m_chunk * plan.m_unit, sides)
        assert used <= SMEM, (rows, bits, used)
        # chunks shrink only where the CHUNK_COLS chunks do not fit
        full = _smem_bytes(
            plan.tile_rows, x_bytes,
            min(plan.k_units, max(1, CHUNK_COLS // plan.k_unit))
            * plan.k_unit,
            min(plan.m_units, max(1, CHUNK_COLS // plan.m_unit))
            * plan.m_unit, sides)
        if full <= SMEM:
            assert (plan.k_chunk, plan.m_chunk) == (
                min(plan.k_units, max(1, CHUNK_COLS // plan.k_unit)),
                min(plan.m_units, max(1, CHUNK_COLS // plan.m_unit)))


@pytest.mark.parametrize("t,k,m,kt,groups", SHAPES)
def test_plan_grid_is_whole_clusters_and_tiles_cover_rows(t, k, m, kt,
                                                          groups):
    plan, _ = _plan(t, k, m, kt, groups)
    # the grid, tiles and copies do not depend on the rank rows or bits
    # (only the staged chunks do)
    for rows, bits, other, _ in _rank_plans(t, k, m, kt, groups,
                                            2 if k else 4):
        assert (other.cluster, other.tile_rows, other.tiles, other.k_units,
                other.m_units) == (plan.cluster, plan.tile_rows, plan.tiles,
                                   plan.k_units, plan.m_units), (rows, bits)
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
    grid = plan.tiles * plan.cluster      # the launcher's gridDim.x
    assert grid % plan.cluster == 0 and grid >= plan.cluster
    assert plan.tile_rows in TILE_ROWS
    if kt is None:                       # fused_lora, matmul_*: any T
        assert (plan.tiles - 1) * plan.tile_rows < t <= (
            plan.tiles * plan.tile_rows)
    else:                                # sgmv_*: tiles of kt rows
        assert plan.tile_rows >= kt and plan.tiles * kt == t
    # the cluster is no larger than the work needs (a B-only grid of plain
    # blocks, at most OUT_BLOCKS of them unless one block per tile exceeds)
    units = max(-(-k // plan.k_unit), -(-m // plan.m_unit))
    want = min(MAX_CLUSTER, 1 << (units - 1).bit_length())
    if k == 0:
        while want > 1 and plan.tiles * want > OUT_BLOCKS:
            want //= 2
    assert plan.cluster == want
    assert len(plan.args()) == 14
    assert list(plan.c_args) == list(plan.args())   # what C reads


def test_plan_fills_the_card_at_decode():
    """A decode batch of 16 rows still gets ~one block per SM: fused_lora
    takes tiles of one row, sgmv_fused's 16 one-row tiles as they come."""
    g = (128, 128, 128, 128)
    for kt in (None, 1):
        plan, _ = _plan(16, 3072, 3072, kt, g)
        assert plan.tile_rows == 1 and plan.tiles * plan.cluster == 128
    prefill, _ = _plan(512, 3072, 3072, None, g)
    assert prefill.tile_rows == 8 and prefill.tiles == 64


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("group", [8, 16, 32, 64, 100, 128])
@pytest.mark.parametrize("ptr", [0, 4, 8, 12])
def test_plan_vector_path_only_where_group_starts_are_aligned(bits, group,
                                                              ptr):
    """16-byte copies only where every group start (of every row of every
    adapter) is 16-byte aligned; else 4-byte copies where those starts are
    4-byte aligned; else byte copies."""
    side = _side(bits, group, ptr)
    plan = _cluster_plan(16, 3072, 3072, 1, 0, 2, 0,
                         (side, _side(2, 128), None, None), SMEM)
    vec = plan.vec_codes[0]
    group_bytes = side[1] * side[2]
    starts = [ptr + i * group_bytes for i in range(64)]
    assert vec in (16, 4, 1)
    assert all(s % vec == 0 for s in starts)
    aligned16 = all(s % 16 == 0 for s in starts)
    aligned4 = all(s % 4 == 0 for s in starts)
    assert vec == (16 if aligned16 else 4 if aligned4 else 1)
    if bits == 3 and group == 128:      # 13 int32 words a group: 52 bytes
        assert vec == 4


@pytest.mark.parametrize("k,x_bytes,unit,want", [
    (3072, 2, 128, 16), (200, 4, 128, 16), (250, 2, 64, 4), (101, 2, 101, 1),
    (100, 4, 100, 16), (30, 4, 30, 4)])
def test_plan_x_and_y_copies(k, x_bytes, unit, want):
    """x rows are copied 16 bytes at a time where every row and K slice
    starts 16-byte aligned; y is stored as float4 where M allows."""
    plan = _cluster_plan(8, k, 200, 8, 0, x_bytes, 0,
                         (_side(2, unit), _side(2, 8), None, None), SMEM)
    assert plan.vec_x == want
    assert plan.vec_y == 4
    odd = _cluster_plan(8, k, 198, 8, 0, x_bytes, 0,
                        (_side(2, unit), _side(2, 8), None, None), SMEM)
    assert odd.vec_y == 1
    shifted = _cluster_plan(8, k, 200, 8, 0, x_bytes, 8,
                            (_side(2, unit), _side(2, 8), None, None), SMEM)
    assert shifted.vec_y == 1


def test_plan_absent_low_side_has_no_copies():
    plan, _ = _plan(16, 3072, 3072, 1, (128, 64, None, None))
    assert plan.vec_codes[2:] == (0, 0)
    assert plan.k_unit == 128 and plan.m_unit == 64


@pytest.mark.parametrize("kt", [None, 1])
def test_rhs_plan_fills_the_card_at_decode(kt):
    """A 16-row decode of matmul_rhs (kt None: tiles of one row) or sgmv_rhs
    (16 one-row tiles) runs 16 clusters of 8 blocks, not 2 blocks; a
    512-row prefill 64 tiles of 8 rows."""
    for k in (3072, 8192):
        plan, _ = _plan(16, k, 0, kt, (128, None, None, None))
        assert plan.tile_rows == 1 and plan.cluster == 8
        assert plan.tiles * plan.cluster >= 128
        prefill, _ = _plan(512, k, 0, 8 if kt else None,
                           (128, None, None, None))
        assert prefill.tile_rows == 8 and prefill.tiles == 64


def test_a_only_plan_needs_m_0_and_no_b_sides():
    with pytest.raises(ValueError, match="A-only"):
        _cluster_plan(16, 3072, 64, 1, 0, 2, 0,
                      (_side(2, 128), None, None, None), SMEM)
    with pytest.raises(ValueError, match="A-only"):
        _cluster_plan(16, 3072, 0, 1, 0, 2, 0,
                      (_side(2, 128), _side(2, 128), None, None), SMEM)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("group", [8, 16, 32, 64, 100, 128])
@pytest.mark.parametrize("ptr", [0, 4, 8, 12])
def test_a_only_plan_copies_as_the_fused_plan(bits, group, ptr):
    """An A-only plan (the rhs kernels) copies A and x exactly as the fused
    plan of the same A side does (so 4-byte copies for 3-bit groups of 13
    words), with no B copies and no float4 stores."""
    side = _side(bits, group, ptr)
    for kt in (None, 1, 8):
        fused = _cluster_plan(16, 3072, 3072, kt, 0, 2, 0,
                              (side, _side(2, 128), None, None), SMEM)
        rhs = _cluster_plan(16, 3072, 0, kt, 0, 2, 0,
                            (side, None, None, None), SMEM)
        assert rhs.vec_codes == (fused.vec_codes[0], 0, 0, 0)
        assert rhs.vec_x == fused.vec_x and rhs.vec_y == 1
        assert (rhs.k_unit, rhs.k_units, rhs.k_chunk) == (
            fused.k_unit, fused.k_units, fused.k_chunk)
        if bits == 3 and group == 128:
            assert rhs.vec_codes[0] == 4


# --------------------------------------------------------------------------
# the B-only plan of the out kernels (matmul_out, sgmv_out): k = 0, no A
# --------------------------------------------------------------------------

def test_b_only_plan_needs_k_0_and_no_a_sides():
    b = _side(2, 128)
    with pytest.raises(ValueError, match="B-only"):
        _cluster_plan(16, 3072, 3072, 1, 0, 4, 0, (None, b, None, None),
                      SMEM)
    with pytest.raises(ValueError, match="B-only"):
        _cluster_plan(16, 0, 3072, 1, 0, 4, 0,
                      (_side(2, 128), b, None, None), SMEM)
    with pytest.raises(ValueError, match="B-only"):
        _cluster_plan(16, 0, 3072, 1, 0, 4, 0,
                      (None, b, _side(1, 128), None), SMEM)
    with pytest.raises(ValueError, match="A or a B side"):
        _cluster_plan(16, 0, 0, 1, 0, 4, 0, (None, None, None, None), SMEM)


@pytest.mark.parametrize("bits,group,m,kt", [
    (3, 130, 200, None), (3, 130, 260, 1), (3, 128, 384, 8),
    (2, 128, 200, None), (2, 128, 200, 8), (2, 128, 32768, None),
    (1, 8, 198, 3), (4, 32, 1000, 2), (8, 64, 8192, 1), (2, 100, 3072, 4)])
def test_b_only_plan_covers_m_once_in_whole_groups(bits, group, m, kt):
    """M slices in block order cover M exactly once, each starting on a
    group boundary; the grid is whole tiles of C blocks; no K, no x."""
    t = 48 if kt is None else 16 * kt
    plan, _ = _plan(t, 0, m, kt, (None, group, None, None),
                    bits=(1, bits, 1, 1), x_bytes=4)
    assert plan.m_unit == group
    assert (plan.k_unit, plan.k_units, plan.k_chunk) == (1, 0, 0)
    assert plan.vec_x == 1 and plan.vec_codes[0::2] == (0, 0)
    slices = _slices(plan, m, "m")
    assert len(slices) == plan.cluster
    _check_cover(slices, m, [group])
    nu = -(-m // group)
    assert plan.cluster == min(MAX_CLUSTER, 1 << (nu - 1).bit_length())
    assert 1 <= plan.m_chunk <= plan.m_units
    assert plan.m_chunk * group <= max(CHUNK_COLS, group)
    if kt is None:
        assert (plan.tiles - 1) * plan.tile_rows < t <= (
            plan.tiles * plan.tile_rows)
    else:
        assert plan.tile_rows >= kt and plan.tiles * kt == t


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("group", [8, 16, 32, 64, 100, 128])
@pytest.mark.parametrize("ptr", [0, 4, 8, 12])
def test_b_only_plan_copies_as_the_fused_plan(bits, group, ptr):
    """A B-only plan (the out kernels) copies B and stores y exactly as the
    fused plan of the same B side does (so 4-byte copies for 3-bit groups
    of 13 words, 16-byte copies only where every group start is 16-byte
    aligned), with no A copies and no x."""
    side = _side(bits, group, ptr)
    for kt in (None, 1, 8):
        fused = _cluster_plan(16, 3072, 3072, kt, 0, 2, 0,
                              (_side(2, 128), side, None, None), SMEM)
        out = _cluster_plan(16, 0, 3072, kt, 0, 4, 0,
                            (None, side, None, None), SMEM)
        assert out.vec_codes == (0, fused.vec_codes[1], 0, 0)
        assert out.vec_y == fused.vec_y and out.vec_x == 1
        assert (out.cluster, out.m_unit, out.m_units, out.m_chunk) == (
            fused.cluster, fused.m_unit, fused.m_units, fused.m_chunk)
        group_bytes = side[1] * side[2]
        starts = [ptr + i * group_bytes for i in range(64)]
        vec = out.vec_codes[1]
        assert vec == (16 if all(s % 16 == 0 for s in starts) else
                       4 if all(s % 4 == 0 for s in starts) else 1)
        if bits == 3 and group == 128:
            assert vec == 4


@pytest.mark.parametrize("m", [200, 198, 256, 260, 3072])
@pytest.mark.parametrize("group", [128, 130, 8, 6])
@pytest.mark.parametrize("out_ptr", [0, 8])
def test_b_only_plan_float4_stores_only_where_m_allows(m, group, out_ptr):
    """y is stored as float4 only where m, the M unit and the output's
    address divide by 4 (16 bytes)."""
    plan = _cluster_plan(8, 0, m, 8, 0, 4, out_ptr,
                         (None, _side(3 if group == 130 else 2, group),
                          None, None), SMEM)
    want = m % 4 == 0 and group % 4 == 0 and out_ptr % 16 == 0
    assert plan.vec_y == (4 if want else 1)


@pytest.mark.parametrize("kt", [None, 1])
def test_out_plan_fills_the_card_at_decode(kt):
    """A 16-row decode of matmul_out (kt None: tiles of one row) or
    sgmv_out (16 one-row tiles) runs 16 tiles of 8 blocks, as the rhs plan
    does; a 512-row prefill 64 tiles of 8 rows."""
    for m in (1024, 3072, 8192):
        plan, _ = _plan(16, 0, m, kt, (None, 128, None, None), x_bytes=4)
        rhs, _ = _plan(16, 3072, 0, kt, (128, None, None, None))
        assert plan.tile_rows == 1 and plan.cluster == 8
        assert plan.tiles * plan.cluster >= 128
        assert (plan.tiles, plan.tile_rows) == (rhs.tiles, rhs.tile_rows)
        prefill, _ = _plan(512, 0, m, 8 if kt else None,
                           (None, 128, None, None), x_bytes=4)
        assert prefill.tile_rows == 8 and prefill.tiles == 64


@pytest.mark.parametrize("kt", [None, 1, 2, 8])
@pytest.mark.parametrize("t", [16, 64, 128, 512, 4096])
def test_out_plan_grid_fits_one_wave(kt, t):
    """A B-only grid (plain blocks) halves its M split while it exceeds
    OUT_BLOCKS, so a 512-row prefill runs 64 tiles x 4 blocks, and still
    covers M exactly once in whole groups; one block per tile is the
    floor."""
    m = 3072
    plan, _ = _plan(t, 0, m, kt, (None, 128, None, None), x_bytes=4)
    grid = plan.tiles * plan.cluster
    assert grid <= OUT_BLOCKS or plan.cluster == 1
    assert plan.cluster == 8 or grid * 2 > OUT_BLOCKS
    _check_cover(_slices(plan, m, "m"), m, [128])
    if t == 512 and kt in (None, 8):
        assert (plan.tiles, plan.cluster) == (64, 4)


# --------------------------------------------------------------------------
# the shared-memory budget: the plan fits any rank one unit can hold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BIT_WIDTHS)
@pytest.mark.parametrize("kt", [None, 1, 8])
def test_plan_fits_rank_rows_up_to_512_in_the_budget(bits, kt):
    """Rank 16 to 256 (32 to 512 rows, high + low) at llama3.2-3b's four
    shapes: the fused, A-only and B-only plans fit the H100's opt-in shared
    memory; rank 16 keeps the CHUNK_COLS chunks it always had, and a plan
    that had to shrink a chunk would not fit with it doubled."""
    t = 16 * (kt or 1)
    for k, m in ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072)):
        for rows in (32, 128, 256, 512):
            for kk, mm, groups, rr, xb in (
                    (k, m, (128,) * 4, (rows // 2, rows // 2), 2),
                    (k, 0, (128, None, None, None), (rows, 0), 2),
                    (0, m, (None, 128, None, None), (rows, 0), 4)):
                plan, sides = _plan(t, kk, mm, kt, groups, bits=(bits,) * 4,
                                    x_bytes=xb, rows=rr)
                kc, mc = plan.k_chunk * plan.k_unit, plan.m_chunk * 128
                assert _smem_bytes(plan.tile_rows, xb, kc,
                                   mm and mc, sides) <= SMEM
                if rows == 32:
                    assert kc == min(kk, plan.k_units * 128, CHUNK_COLS)
                if plan.k_chunk > 1 and plan.k_chunk < plan.k_units:
                    assert _smem_bytes(plan.tile_rows, xb, 2 * kc,
                                       mm and mc, sides) > SMEM


@pytest.mark.parametrize("smem", [48 << 10, 100 << 10, SMEM])
def test_plan_halves_k_then_m_chunks_to_the_budget(smem):
    """Under a smaller budget the K chunk shrinks first, then the M chunk,
    each down to one unit, and the layout fits the budget given."""
    groups = (128,) * 4
    for rows in (16, 32, 64, 128):
        try:
            plan, sides = _plan(512, 3072, 8192, 8, groups, bits=(8,) * 4,
                                rows=(rows, rows), smem=smem)
        except ValueError:           # one unit each does not fit either
            sides = _plan(512, 3072, 8192, 8, groups, bits=(8,) * 4,
                          rows=(rows, rows))[1]
            assert _smem_bytes(8, 2, 128, 128, sides) > smem
            assert rows > 16
            continue
        full_k = min(plan.k_units, CHUNK_COLS // 128)
        full_m = min(plan.m_units, CHUNK_COLS // 128)
        assert _smem_bytes(plan.tile_rows, 2, plan.k_chunk * 128,
                           plan.m_chunk * 128, sides) <= smem
        if plan.m_chunk < full_m:
            assert plan.k_chunk == 1
        assert plan.k_chunk <= full_k


@pytest.mark.parametrize("bits", BIT_WIDTHS)
def test_plan_raises_where_one_unit_cannot_fit(bits):
    """A rank whose single K and M units exceed the card's shared memory
    is refused with the bytes needed and the bytes offered."""
    want = "needs [0-9]+ bytes.*offers 232448"
    with pytest.raises(ValueError, match=want):
        _plan(16, 3072, 3072, 1, (128,) * 4, bits=(bits,) * 4,
              rows=(8192, 8192))
    with pytest.raises(ValueError, match=want):
        _plan(16, 3072, 0, 1, (128, None, None, None), bits=(bits,) * 4,
              rows=(16384, 0))
    with pytest.raises(ValueError, match=want):
        _plan(16, 0, 3072, 1, (None, 128, None, None), bits=(bits,) * 4,
              x_bytes=4, rows=(16384, 0))
    # a budget below the fixed terms (h, x and y of one unit) refuses rank 8
    with pytest.raises(ValueError, match="offers 1024"):
        _plan(16, 3072, 3072, 8, (128,) * 4, rows=(8, 8), smem=1024)
