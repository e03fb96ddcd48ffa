"""Port vs reference: qwen2-vl-72b's language backbone at its smoke size
(sections (4, 6, 6) of M-RoPE), fp32 on the CPU: packed model-level
prefill and decode of text (the three position streams equal), a prefill
with precomputed vision embeddings prepended and a real (temporal,
height, width) position grid, and the continuous engine, which serves
text as the reference's does. Helpers:
``tests/test_torch_dense_variants.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_dense_variants import (DenseModels, continuous_parity,
                                       packed_model_parity)

ARCH = "qwen2-vl-72b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    return DenseModels(ARCH)


def test_text_prefill_and_decode_match_reference(models):
    g = np.random.default_rng(0)
    batch = {"tokens": g.integers(0, 512, (2, 16)).astype(np.int32),
             "start": np.asarray([4, 0], np.int32)}
    packed_model_parity(models, batch)


def _grid(b, n_vis, n_txt, side=4):
    """Qwen2-VL positions: a vision patch i sits at (0, i // side,
    i mod side); text after it at max + 1 + j on all three streams."""
    vis = np.stack([np.zeros(n_vis), np.arange(n_vis) // side,
                    np.arange(n_vis) % side])
    txt = np.broadcast_to(vis.max() + 1 + np.arange(n_txt), (3, n_txt))
    pos = np.concatenate([vis, txt], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, b, n_vis + n_txt)))


def test_vision_prefix_with_mrope_grid_matches_reference(models):
    """8 vision embeddings prepended to 8 text tokens, positions the 2-D
    patch grid then text: logits over all 16 positions, then decode."""
    g = np.random.default_rng(1)
    batch = {"tokens": g.integers(0, 512, (2, 8)).astype(np.int32)}
    extra = {"vision_embeds": (0.02 * g.normal(size=(2, 8, 128))).astype(
                 np.float32),
             "positions": _grid(2, 8, 8)}
    assert len({tuple(extra["positions"][:, 0, i]) for i in range(8)}) == 8
    packed_model_parity(models, batch, extra)


def test_continuous_engine_tokens_match_reference(models):
    continuous_parity(models, ["u0", "u1", "u2", "u0", "u1"], plen=9)


def test_chip_smoke_dense_phases_rehearse_on_the_cpu():
    """``chip_smoke.py``'s phases 23-27 at the smoke sizes on the CPU (the
    plain versions in place of the kernels): each dense variant's bf16
    continuous serve with the reference's paging and 2 layers x 7
    launches per forward, its fp32 parity with the control, gemma2's
    long prompt past its window with the soft-capped blockwise attention
    check, and musicgen at the model level."""
    from test_torch_faults import ROOT, load

    chip_smoke = load("chip_smoke", ROOT / "chip_smoke.py")
    for arch in chip_smoke.DENSE_ARCHS:
        serve = chip_smoke.phase_dense_serve(arch, "cpu", "smoke")
        assert serve["launches"] == 2 * 7 * 24      # 3 groups + 21 steps
        parity = chip_smoke.phase_dense_parity(arch, "cpu", "smoke")
        assert parity["gap"] <= parity["tol"] and parity["layers"] == 2
    long = chip_smoke.phase_gemma_long("cpu", "smoke")
    assert long["gap"] <= long["tol"] and long["attn_err_8"] < 1e-5
    music = chip_smoke.phase_musicgen("cpu", "smoke")
    assert music["launches"] == 2 * 7 * 8 and music["gap"] <= music["tol"]
