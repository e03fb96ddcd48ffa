"""Port vs reference: the multi-adapter apply ``sgmv_apply`` and its
kernels ``sgmv_rhs``, ``sgmv_out`` and ``sgmv_fused`` (single side, and
two-sided with separate widths, ranks and groups), against the JAX
package's same functions, whose Pallas kernels run with
``interpret=True`` on the CPU. The port runs its plain versions here; the
CUDA kernels are held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: ``rtol = atol = 1e-5``, the JAX package's own for
``sgmv_apply`` against ``ref_sgmv`` (both sum fp32 products in other
orders; inputs of scale 0.05 as in its tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import binary_quantize as j_binary_quantize
from repro.core.quant import rtn_quantize as j_rtn_quantize
from repro.kernels import sgmv_apply as j_sgmv_apply
from repro.kernels.quant_matmul import kernel as jk
from repro.kernels.quant_matmul.ops import stack_adapter_side as j_stack_side
from repro.kernels.quant_matmul.ref import ref_sgmv as j_ref_sgmv
from repro_torch.bridge import quantized_tensor
from repro_torch.kernels import sgmv_apply, stack_adapter_side
from repro_torch.kernels.quant_matmul import (LAUNCH_COUNTS, PLAIN_CALLS,
                                               ref, reset_launch_counts,
                                               sgmv_fused, sgmv_out, sgmv_rhs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TOL = dict(rtol=1e-5, atol=1e-5)
FORMATS = {"rtn2": ("rtn", 2), "rtn3": ("rtn", 3), "rtn4": ("rtn", 4),
           "binary": ("binary", 1)}
SEGS = [[0, 1, 2, 1], [2, 2, 0], [1]]


def _rand(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.05).astype(
        np.float32)


def _quantize(w, fmt, group, axis):
    mode, bits = FORMATS[fmt]
    w = jnp.asarray(w)
    if mode == "rtn":
        return j_rtn_quantize(w, bits, group, axis=axis)
    return j_binary_quantize(w, group, axis=axis)


def _adapters(k, m, fmt, r=16, na=3, seed=10, group=128):
    """``na`` adapters' A ``(r, K)`` row-grouped and B ``(M, r)``
    column-grouped (the Bᵀ view), quantized by JAX; with the bridged
    copies for the port."""
    qas = [_quantize(_rand((r, k), seed + i), fmt, group, 1)
           for i in range(na)]
    qbs = [_quantize(_rand((m, r), seed + 20 + i), fmt, group, 0)
           for i in range(na)]
    return qas, qbs, ([quantized_tensor(q, "cpu") for q in qas],
                      [quantized_tensor(q, "cpu") for q in qbs])


def _stacked(jqs, tqs):
    """Both packages' ``stack_adapter_side``, held bit-exact."""
    jside = j_stack_side(jqs)
    tside = stack_adapter_side(tqs)
    for j, t in zip(jside, tside):
        np.testing.assert_array_equal(t.numpy().astype(np.int64)
                                      if t.dtype != torch.float32
                                      else t.numpy(),
                                      np.asarray(j).astype(np.int64)
                                      if t.dtype != torch.float32
                                      else np.asarray(j))
    return jside, tside


def _fmt_kw(q):
    return dict(bits=q.bits, binary=q.mode == "binary", group=q.group_size)


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("segs", SEGS)
@pytest.mark.parametrize("tile_t", [1, 8])
def test_sgmv_kernels_vs_pallas(fmt, segs, tile_t, k=384, m=256):
    """``sgmv_rhs``, ``sgmv_out`` and the single-side ``sgmv_fused`` give
    JAX's kernels' outputs, one plain call each."""
    qas, qbs, (tas, tbs) = _adapters(k, m, fmt)
    (ja, tA), (jb, tB) = _stacked(qas, tas), _stacked(qbs, tbs)
    x = _rand((len(segs) * tile_t, k), seed=3)
    seg = np.asarray(segs, np.int32)
    kw_a, kw_b = _fmt_kw(qas[0]), _fmt_kw(qbs[0])

    jh = jk.sgmv_rhs(jnp.asarray(x), *ja, jnp.asarray(seg), tile_t=tile_t,
                     interpret=True, **kw_a)
    jy = jk.sgmv_out(jh, *jb, jnp.asarray(seg), tile_t=tile_t,
                     interpret=True, **kw_b)
    jf = jk.sgmv_fused(
        jnp.asarray(x), *ja, *jb, jnp.asarray(seg),
        bits_a=kw_a["bits"], binary_a=kw_a["binary"], group_a=kw_a["group"],
        bits_b=kw_b["bits"], binary_b=kw_b["binary"], group_b=kw_b["group"],
        tile_t=tile_t, interpret=True)

    reset_launch_counts()
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    th = sgmv_rhs(xt, *tA, st, tile_t=tile_t, **kw_a)
    ty = sgmv_out(th, *tB, st, tile_t=tile_t, **kw_b)
    tf = sgmv_fused(
        xt, *tA, *tB, st,
        bits_a=kw_a["bits"], binary_a=kw_a["binary"], group_a=kw_a["group"],
        bits_b=kw_b["bits"], binary_b=kw_b["binary"], group_b=kw_b["group"],
        tile_t=tile_t)
    assert dict(PLAIN_CALLS) == {"sgmv_rhs": 1, "sgmv_out": 1,
                                 "sgmv_fused": 1} and not LAUNCH_COUNTS
    _close(th.numpy(), np.asarray(jh))
    _close(ty.numpy(), np.asarray(jy))
    _close(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("fmt", ["rtn3", "binary"])
def test_sgmv_kernels_m_not_multiple_of_group(fmt, k=256, m=200, tile_t=1):
    """M = 200 with groups of 128: ``sgmv_out`` and ``sgmv_fused`` write
    exactly ``m`` columns, as the JAX kernels slice them."""
    qas, qbs, (tas, tbs) = _adapters(k, m, fmt, seed=50)
    (ja, tA), (jb, tB) = _stacked(qas, tas), _stacked(qbs, tbs)
    seg = np.asarray([2, 0, 1, 1, 0], np.int32)
    x = _rand((len(seg), k), seed=4)
    kw_a, kw_b = _fmt_kw(qas[0]), _fmt_kw(qbs[0])
    jy = jk.sgmv_out(jk.sgmv_rhs(jnp.asarray(x), *ja, jnp.asarray(seg),
                                 tile_t=tile_t, interpret=True, **kw_a),
                     *jb, jnp.asarray(seg), m=m, tile_t=tile_t,
                     interpret=True, **kw_b)
    jf = jk.sgmv_fused(
        jnp.asarray(x), *ja, *jb, jnp.asarray(seg),
        bits_a=kw_a["bits"], binary_a=kw_a["binary"], group_a=kw_a["group"],
        bits_b=kw_b["bits"], binary_b=kw_b["binary"], group_b=kw_b["group"],
        m=m, tile_t=tile_t, interpret=True)
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    ty = sgmv_out(sgmv_rhs(xt, *tA, st, tile_t=tile_t, **kw_a), *tB, st,
                  m=m, tile_t=tile_t, **kw_b)
    tf = sgmv_fused(
        xt, *tA, *tB, st,
        bits_a=kw_a["bits"], binary_a=kw_a["binary"], group_a=kw_a["group"],
        bits_b=kw_b["bits"], binary_b=kw_b["binary"], group_b=kw_b["group"],
        m=m, tile_t=tile_t)
    _close(ty.numpy(), np.asarray(jy))
    _close(tf.numpy(), np.asarray(jf))
    assert ty.shape == tf.shape == (len(seg), m)


@pytest.mark.parametrize("fmt", ["rtn2", "rtn3", "binary"])
@pytest.mark.parametrize("fused", [True, False])
def test_sgmv_apply_vs_reference(fmt, fused, k=384, m=256, tile=8):
    """``sgmv_apply`` against JAX's ``sgmv_apply`` and both packages'
    ``ref_sgmv``, with the reference's launch counts: 1 ``sgmv_fused``, or
    1 ``sgmv_rhs`` + 1 ``sgmv_out``."""
    qas, qbs, (tas, tbs) = _adapters(k, m, fmt, seed=30)
    segs = [1, 0, 2, 2]
    seg_ids = np.repeat(segs, tile)
    x = _rand((len(seg_ids), k), seed=6)
    seg = np.asarray(segs, np.int32)
    jk.reset_launch_counts()
    want = np.asarray(j_sgmv_apply(jnp.asarray(x), qas, qbs,
                                   jnp.asarray(seg), scaling=1.5,
                                   tile_t=tile, interpret=True, fused=fused))
    j_counts = dict(jk.LAUNCH_COUNTS)
    reset_launch_counts()
    got = sgmv_apply(torch.from_numpy(x), tas, tbs, torch.from_numpy(seg),
                     scaling=1.5, tile_t=tile, fused=fused)
    assert dict(PLAIN_CALLS) == j_counts == (
        {"sgmv_fused": 1} if fused else {"sgmv_rhs": 1, "sgmv_out": 1})
    assert not LAUNCH_COUNTS and got.dtype == torch.float32
    _close(got.numpy(), want)
    oracle = 1.5 * np.asarray(j_ref_sgmv(jnp.asarray(x), qas, qbs, seg_ids))
    _close(got.numpy(), oracle)
    _close(1.5 * ref.ref_sgmv(torch.from_numpy(x), tas, tbs,
                              seg_ids).numpy(), oracle)


def test_sgmv_apply_exact_m_where_reference_pads(k=256, m=200, tile=8):
    """ROADMAP C6: with M = 200 (groups of 128) JAX's fused ``sgmv_apply``
    returns B's group-padded 256 columns while its two-pass path and
    ``ref_sgmv`` return 200. The port gives exactly M columns both ways,
    equal to the reference's first 200 and to ``ref_sgmv``."""
    qas, qbs, (tas, tbs) = _adapters(k, m, "rtn2", seed=70)
    segs = [2, 0, 1]
    seg_ids = np.repeat(segs, tile)
    x = _rand((len(seg_ids), k), seed=8)
    seg = np.asarray(segs, np.int32)
    oracle = np.asarray(j_ref_sgmv(jnp.asarray(x), qas, qbs, seg_ids))
    j_fused = np.asarray(j_sgmv_apply(jnp.asarray(x), qas, qbs,
                                      jnp.asarray(seg), tile_t=tile,
                                      interpret=True, fused=True))
    j_two = np.asarray(j_sgmv_apply(jnp.asarray(x), qas, qbs,
                                    jnp.asarray(seg), tile_t=tile,
                                    interpret=True, fused=False))
    assert j_fused.shape == (len(seg_ids), 256)
    assert j_two.shape == oracle.shape == (len(seg_ids), m)
    for fused in (True, False):
        got = sgmv_apply(torch.from_numpy(x), tas, tbs,
                         torch.from_numpy(seg), tile_t=tile,
                         fused=fused).numpy()
        _close(got, oracle)
        _close(got, j_fused[:, :m])
        _close(got, j_two)


# two-sided forms: (A_hi, B_hi) widths, hi binary, low side (bits, binary),
# and groups (A_hi, B_hi, A_lo, B_lo)
TWO_SIDED = {
    "rtn3_4+binary": (3, 4, False, (1, True), (128, 64, 64, 128)),
    "binary+rtn2": (1, 1, True, (2, False), (64, 128, 128, 64)),
}


@pytest.mark.parametrize("case", sorted(TWO_SIDED))
@pytest.mark.parametrize("tile_t", [1, 8])
def test_sgmv_fused_two_sided_other_rank_and_groups(case, tile_t, k=256,
                                                    m=192):
    """The full contract of ``sgmv_fused``: A and B of the high side with
    their own widths (or a binary high side), a low side of another rank
    (8 against 16), format and groups, against JAX's kernel."""
    bits_a, bits_b, bin_hi, (bits_lo, bin_lo), groups = TWO_SIDED[case]
    ga, gb, gal, gbl = groups

    def q(w, bits, binary, group, axis):
        w = jnp.asarray(w)
        return (j_binary_quantize(w, group, axis=axis) if binary
                else j_rtn_quantize(w, bits, group, axis=axis))

    na = 3
    sides = {
        "ah": [q(_rand((16, k), 100 + i), bits_a, bin_hi, ga, 1)
               for i in range(na)],
        "bh": [q(_rand((m, 16), 110 + i), bits_b, bin_hi, gb, 0)
               for i in range(na)],
        "al": [q(_rand((8, k), 120 + i), bits_lo, bin_lo, gal, 1)
               for i in range(na)],
        "bl": [q(_rand((m, 8), 130 + i), bits_lo, bin_lo, gbl, 0)
               for i in range(na)],
    }
    st = {n: _stacked(qs, [quantized_tensor(v, "cpu") for v in qs])
          for n, qs in sides.items()}
    seg = np.asarray([1, 2, 0, 1], np.int32)
    x = _rand((len(seg) * tile_t, k), seed=9)
    kw = dict(bits_a=bits_a, binary_a=bin_hi, group_a=ga, bits_b=bits_b,
              binary_b=bin_hi, group_b=gb, bits_lo=bits_lo,
              binary_lo=bin_lo, group_al=gal, group_bl=gbl, m=m, tile_t=tile_t)
    want = np.asarray(jk.sgmv_fused(
        jnp.asarray(x), *st["ah"][0], *st["bh"][0], jnp.asarray(seg),
        a_lo=st["al"][0], b_lo=st["bl"][0], interpret=True, **kw))
    reset_launch_counts()
    got = sgmv_fused(torch.from_numpy(x), *st["ah"][1], *st["bh"][1],
                     torch.from_numpy(seg), a_lo=st["al"][1],
                     b_lo=st["bl"][1], **kw).numpy()
    assert dict(PLAIN_CALLS) == {"sgmv_fused": 1}
    assert st["al"][1][0].shape[1] == 8 and st["ah"][1][0].shape[1] == 16
    _close(got, want)


def test_sgmv_wrapper_checks(k=256, m=256):
    qas, qbs, (tas, tbs) = _adapters(k, m, "rtn2", seed=90)
    a, b = stack_adapter_side(tas), stack_adapter_side(tbs)
    x = torch.from_numpy(_rand((8, k), seed=1))
    seg = torch.zeros(1, dtype=torch.int32)
    kw = dict(bits=2, binary=False, group=128)
    with pytest.raises(ValueError, match="tile_t <= 8"):
        sgmv_rhs(torch.randn(16, k), *a, seg, tile_t=16, **kw)
    with pytest.raises(ValueError, match="seg_map"):
        sgmv_rhs(x, *a, seg.long(), **kw)
    with pytest.raises(ValueError, match="groups of"):
        sgmv_out(torch.zeros(8, 16), *b, seg, m=100, **kw)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        sgmv_rhs(x.double(), *a, seg, **kw)
    with pytest.raises(ValueError, match="float32"):
        sgmv_out(torch.zeros(8, 16, dtype=torch.bfloat16), *b, seg, **kw)
    with pytest.raises(ValueError, match="both low-side"):
        sgmv_fused(x, *a, *b, seg, bits_a=2, binary_a=False, group_a=128,
                   bits_b=2, binary_b=False, group_b=128, a_lo=a)
    with pytest.raises(ValueError, match="unsupported format"):
        sgmv_fused(x, *a, *b, seg, bits_a=2, binary_a=True, group_a=128,
                   bits_b=2, binary_b=False, group_b=128)
    # a binary side's zero-points are never read and may be None
    bq = [quantized_tensor(j_binary_quantize(jnp.asarray(_rand((16, k), i)),
                                             128, axis=1), "cpu")
          for i in range(2)]
    bc, bs, _ = stack_adapter_side(bq)
    h = sgmv_rhs(x, bc, bs, None, seg, bits=1, binary=True, group=128)
    assert h.shape == (8, 16)
    with pytest.raises(ValueError, match="needs its zero-points"):
        sgmv_rhs(x, a[0], a[1], None, seg, **kw)
