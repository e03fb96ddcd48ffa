"""The launch plan of the cluster kernels (``fused_lora``, ``sgmv_fused``
and the A-only ``matmul_rhs``, ``sgmv_rhs``): ``_cluster_plan`` in
``repro_torch/kernels/quant_matmul/kernel.py`` is pure Python, so its
guarantees are held here on the CPU: the blocks of a cluster cover K and M
exactly once in whole quant groups of every side, the grid is whole
clusters, and a side's codes are copied 16 bytes at a time only where every
group start is 16-byte aligned."""

import math

import pytest

from repro_torch.kernels.quant_matmul.kernel import (CHUNK_COLS, MAX_CLUSTER,
                                                     TILE_ROWS, _cluster_plan,
                                                     _per_word)


def _side(bits, group, ptr=0):
    """``(group, words_per_group, word_bytes, codes address mod 16)`` of a
    side."""
    return (group, -(-group // _per_word(bits)), 4 if bits == 3 else 1, ptr)


def _plan(t, k, m, kt, groups, bits=(2, 2, 1, 1), x_bytes=2):
    """The plan of one call; ``groups`` ``(ah, bh, al, bl)``, None for an
    absent side (bh None: an A-only call, m = 0)."""
    sides = [None if g is None else _side(b, g)
             for b, g in zip(bits, groups)]
    return _cluster_plan(t, k, m, kt, 0, x_bytes, 0, tuple(sides)), sides


def _slices(plan, dim, axis):
    """``[(start, stop)]`` columns of ``dim`` that each block of a cluster
    owns (the kernel's ``ku0 = rank·k_units``), empty for idle blocks."""
    unit, units = ((plan.k_unit, plan.k_units) if axis == "k"
                   else (plan.m_unit, plan.m_units))
    return [(min(dim, b * units * unit), min(dim, (b + 1) * units * unit))
            for b in range(plan.cluster)]


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
]


@pytest.mark.parametrize("t,k,m,kt,groups", SHAPES)
def test_plan_slices_cover_k_and_m_exactly_once(t, k, m, kt, groups):
    plan, _ = _plan(t, k, m, kt, groups)
    a_groups = [g for g in (groups[0], groups[2]) if g]
    b_groups = [g for g in (groups[1], groups[3]) if g]
    assert plan.k_unit == math.lcm(*a_groups)
    assert plan.m_unit == math.lcm(*b_groups)
    for axis, dim, gs in (("k", k, a_groups), ("m", m, b_groups)):
        slices = _slices(plan, dim, axis)
        assert len(slices) == plan.cluster
        _check_cover(slices, dim, gs)
    # a staging chunk stays within CHUNK_COLS unless one unit is wider; an
    # A-only plan stages no M
    for unit, units, chunk in ((plan.k_unit, plan.k_units, plan.k_chunk),
                               (plan.m_unit, plan.m_units, plan.m_chunk)):
        if units == 0:
            assert m == 0 and chunk == 0 and unit == 1
            continue
        assert 1 <= chunk <= units
        assert chunk * unit <= max(CHUNK_COLS, unit)


@pytest.mark.parametrize("t,k,m,kt,groups", SHAPES)
def test_plan_grid_is_whole_clusters_and_tiles_cover_rows(t, k, m, kt,
                                                          groups):
    plan, _ = _plan(t, k, m, kt, groups)
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
    grid = plan.tiles * plan.cluster      # the launcher's gridDim.x
    assert grid % plan.cluster == 0 and grid >= plan.cluster
    assert plan.tile_rows in TILE_ROWS
    if kt is None:                       # fused_lora, matmul_rhs: any T
        assert (plan.tiles - 1) * plan.tile_rows < t <= (
            plan.tiles * plan.tile_rows)
    else:                                # sgmv_*: tiles of kt rows
        assert plan.tile_rows >= kt and plan.tiles * kt == t
    # the cluster is no larger than the work needs
    units = max(-(-k // plan.k_unit), -(-m // plan.m_unit))
    assert plan.cluster == min(MAX_CLUSTER, 1 << (units - 1).bit_length())
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
                         (side, _side(2, 128), None, None))
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
                         (_side(2, unit), _side(2, 8), None, None))
    assert plan.vec_x == want
    assert plan.vec_y == 4
    odd = _cluster_plan(8, k, 198, 8, 0, x_bytes, 0,
                        (_side(2, unit), _side(2, 8), None, None))
    assert odd.vec_y == 1
    shifted = _cluster_plan(8, k, 200, 8, 0, x_bytes, 8,
                            (_side(2, unit), _side(2, 8), None, None))
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
                      (_side(2, 128), None, None, None))
    with pytest.raises(ValueError, match="A-only"):
        _cluster_plan(16, 3072, 0, 1, 0, 2, 0,
                      (_side(2, 128), _side(2, 128), None, None))


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
                              (side, _side(2, 128), None, None))
        rhs = _cluster_plan(16, 3072, 0, kt, 0, 2, 0,
                            (side, None, None, None))
        assert rhs.vec_codes == (fused.vec_codes[0], 0, 0, 0)
        assert rhs.vec_x == fused.vec_x and rhs.vec_y == 1
        assert (rhs.k_unit, rhs.k_units, rhs.k_chunk) == (
            fused.k_unit, fused.k_units, fused.k_chunk)
        if bits == 3 and group == 128:
            assert rhs.vec_codes[0] == 4
