"""Port vs reference: the training step (ROADMAP A8a) at smoke size, fp32
on the CPU — the synthetic data pipeline, AdamW and its schedule,
``Model.train_loss`` with its gradients, ``make_train_step`` with
microbatches, and a short ``trained_setup``-shaped run.

Parameters are initialized by JAX and carried across by the bridge; every
input comes from a numpy seed. The training entry point ``launch/train.main``
is not held here: it fails on the reference (ROADMAP C1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.data import pipeline as jdata
from repro.launch import step as jstep
from repro.models import build_model as j_build_model
from repro.optim import adamw as jopt
from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tdata
from repro_torch.launch import step as tstep
from repro_torch.models import build_model
from repro_torch.optim import adamw as topt

# fp32 loss and gradients of a 2-layer model: the two frameworks sum the
# same products in different orders; relative to each leaf's max |grad|
GRAD_RTOL = 1e-5
OPT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op thread pool would only
    contend with the other test workers for the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t_leaves(tree):
    return [l.detach().numpy() for l in topt.tree_leaves(tree)]


def close_leaves(got, want, rtol=GRAD_RTOL, what=""):
    """Each leaf within ``rtol`` of its own max |value| (same leaf order:
    dict keys sorted in both)."""
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} leaf {i}")


def close(got, want, rtol=GRAD_RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def to_t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

DATA_CASES = {
    "plain": dict(seq_len=24, global_batch=4, vocab=300, seed=3),
    "codebook": dict(seq_len=16, global_batch=2, vocab=64, seed=5,
                     n_codebooks=4),
    "vision": dict(seq_len=12, global_batch=3, vocab=128, seed=9,
                   vision_tokens=5, d_model=32),
    "shard": dict(seq_len=8, global_batch=8, vocab=50, seed=1,
                  shard_index=1, shard_count=2),
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_batches_bit_exact(case):
    kw = DATA_CASES[case]
    jc, tc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    for step in (0, 1, 17, 10_000):
        want, got = jdata.make_batch(jc, step), tdata.make_batch(tc, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    for want, got, _ in zip(jdata.synthetic_batches(jc, 4),
                            tdata.synthetic_batches(tc, 4), range(3)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def _rand_tree(rng, scale=1.0):
    """A nested tree with unsorted dict keys, a list and mixed shapes."""
    r = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"z": {"b": r(3, 4), "a": r(5)},
            "groups": [{"w": r(2, 3, 4)}, {"w": r(7)}],
            "m": r(1, 6)}


def test_cosine_with_warmup_matches_reference():
    for cfg in (jopt.OptimizerConfig(), jopt.OptimizerConfig(
            lr=3e-3, total_steps=37, warmup_frac=0.25, alpha_f=0.05),
            jopt.OptimizerConfig(total_steps=1)):
        tcfg = topt.OptimizerConfig(**dataclasses.asdict(cfg))
        for step in list(range(0, 40)) + [250, 999, 1000, 1500]:
            want = np.asarray(jopt.cosine_with_warmup(step, cfg))
            got = topt.cosine_with_warmup(step, tcfg)
            assert got.dtype == torch.float32
            close(got, want, OPT_RTOL)
            close(topt.cosine_with_warmup(torch.tensor(step,
                                                       dtype=torch.int32),
                                          tcfg), want, OPT_RTOL)


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_global_norm_and_clip_match_reference(scale):
    tree = _rand_tree(np.random.default_rng(1), scale)
    ttree = to_torch(tree, "cpu")
    assert [l.shape for l in topt.tree_leaves(ttree)] == [
        l.shape for l in jax.tree_util.tree_leaves(tree)]
    close(topt.global_norm(ttree), jopt.global_norm(tree), OPT_RTOL)
    jc, jn = jopt.clip_by_global_norm(tree, 1.0)
    tcl, tn = topt.clip_by_global_norm(ttree, 1.0)
    close(tn, jn, OPT_RTOL)
    close_leaves(t_leaves(tcl), jc, OPT_RTOL, "clipped")


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference(weight_decay):
    rng = np.random.default_rng(2)
    params, grads = _rand_tree(rng), _rand_tree(rng, 3.0)
    cfg = jopt.OptimizerConfig(lr=1e-2, total_steps=10,
                               weight_decay=weight_decay)
    tcfg = topt.OptimizerConfig(**dataclasses.asdict(cfg))
    jstate, tstate = jopt.init_opt_state(params), topt.init_opt_state(
        to_torch(params, "cpu"))
    jp, tp = params, to_torch(params, "cpu")
    for i in range(3):                 # three updates: moments and schedule
        g = jax.tree_util.tree_map(lambda x: x * (1 + i), grads)
        jp, jstate, jm = jopt.adamw_update(g, jstate, jp, cfg)
        tp, tstate, tm = topt.adamw_update(to_torch(g, "cpu"), tstate, tp,
                                           tcfg)
        assert int(tstate.step) == int(jstate.step) == i + 1
        close(tm["lr"], jm["lr"], OPT_RTOL)
        close(tm["grad_norm"], jm["grad_norm"], OPT_RTOL)
        close_leaves(t_leaves(tp), jp, OPT_RTOL, f"params {i}")
        close_leaves(t_leaves(tstate.mu), jstate.mu, OPT_RTOL, f"mu {i}")
        close_leaves(t_leaves(tstate.nu), jstate.nu, OPT_RTOL, f"nu {i}")


# --------------------------------------------------------------------------
# train_loss and its gradients, per architecture
# --------------------------------------------------------------------------

# llama; gemma2's soft-caps; mixtral's aux (drop-free capacity);
# qwen2-vl's vision prefix sliced off; musicgen's codebooks in one CE
ARCHS = ("gemma2-2b", "llama3.2-3b", "mixtral-8x22b", "musicgen-medium",
         "qwen2-vl-72b")


def _nonzero_b(lora, key):
    """Every LoRA ``B`` drawn small and nonzero (init has B = 0, which
    makes A's gradient vanish)."""
    leaves, tdef = jax.tree_util.tree_flatten_with_path(lora)
    keys = jax.random.split(key, len(leaves))
    out = [0.05 * jax.random.normal(k, l.shape, l.dtype)
           if p[-1].key == "b" else l
           for (p, l), k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(tdef, out)


def _arch_setup(arch):
    jcfg = smoke_cfg(arch)
    tcfg = dataclasses.replace(get_config(arch, "smoke"), dtype=torch.float32)
    if jcfg.moe is not None:           # drop-free: capacity past every route
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=float(jcfg.moe.n_experts)))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=float(tcfg.moe.n_experts)))
    jmodel = j_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    params = {"base": params["base"],
              "lora": _nonzero_b(params["lora"], jax.random.PRNGKey(1))}
    dc = jdata.DataConfig(
        seq_len=16, global_batch=4, vocab=jcfg.vocab, seed=7,
        n_codebooks=jcfg.n_codebooks,
        vision_tokens=4 if jcfg.vision_stub else 0, d_model=jcfg.d_model)
    batch = jdata.make_batch(dc, 3)
    # one masked target per row exercises the targets >= 0 mask
    batch["targets"] = batch["targets"].copy()
    batch["targets"][..., 2] = -1
    return jcfg, jmodel, params, build_model(tcfg), batch


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    """Loss, CE, aux and the gradients of every LoRA leaf and of the whole
    base (``trained_setup`` pretrains the base) within GRAD_RTOL."""
    jcfg, jmodel, params, tmodel, batch = _arch_setup(arch)
    jb = to_j(batch)

    def jloss(p, wrt):
        def f(x):
            full = dict(p, **{wrt: x})
            return jmodel.train_loss(full, jb)
        return jax.value_and_grad(f, has_aux=True)(p[wrt])

    tparams = to_torch(params, "cpu")
    tb = to_t(batch)
    for wrt in ("lora", "base"):
        (jl, jm), jg = jloss(params, wrt)
        leaves = topt.tree_leaves(tparams[wrt])
        for l in leaves:
            l.requires_grad_(True)
        loss, metrics = tmodel.train_loss(tparams, tb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for l in leaves:
            l.requires_grad_(False)
        close(loss, jl)
        close(metrics["ce"], jm["ce"])
        if jcfg.moe is not None:
            assert float(jm["aux"]) > 0
            close(metrics["aux"], jm["aux"])
        else:
            assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
        got = [np.zeros(l.shape, np.float32) if g is None else g.numpy()
               for g, l in zip(grads, leaves)]
        close_leaves(got, jg, GRAD_RTOL, f"{arch} d/d{wrt}")


def test_forward_matches_reference_and_remat_changes_nothing():
    """``forward``'s logits and aux, and ``remat=True`` giving exactly the
    loss and gradients of ``remat=False`` (mixtral: the aux through the
    recomputed layers too)."""
    jcfg, jmodel, params, tmodel, batch = _arch_setup("mixtral-8x22b")
    tparams = to_torch(params, "cpu")
    jlog, jaux = jmodel.forward(params, to_j(batch))
    tlog, taux = tmodel.forward(tparams, to_t(batch))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=0, atol=2e-5 * np.abs(jlog).max())
    close(taux, jaux)
    rmodel = build_model(tmodel.cfg, remat=True)
    assert rmodel.remat and not tmodel.remat
    out = []
    for m in (tmodel, rmodel):
        leaves = topt.tree_leaves(tparams["lora"])
        for l in leaves:
            l.requires_grad_(True)
        loss, metrics = m.train_loss(tparams, to_t(batch))
        out.append((loss, metrics["aux"],
                    torch.autograd.grad(loss, leaves)))
        for l in leaves:
            l.requires_grad_(False)
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for x, y in zip(g0, g1):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# make_train_step and the other steps
# --------------------------------------------------------------------------

def test_split_microbatches_matches_reference():
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "vision_embeds": rng.normal(size=(4, 2, 3)).astype(np.float32),
             "positions": rng.integers(0, 9, (3, 4, 6)).astype(np.int32)}
    want = jstep._split_microbatches(to_j(batch), 2)
    got = tstep._split_microbatches(to_t(batch), 2)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tuple(got["positions"].shape) == (2, 3, 2, 6)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_make_train_step_matches_reference(n_micro):
    """Two steps of ``make_train_step``: loss, CE, aux, lr and grad norm,
    the optimizer moments (mixtral, so the aux flows through the
    accumulated microbatches) and the updated LoRA leaves. Adam normalizes
    each update to about lr, so an entry whose gradient is near eps moves by
    an amount that rounding decides (1.7 % of lr seen): the leaves are held
    to 5 % of lr, which a wrong sign, schedule or bias correction exceeds
    by far."""
    jcfg, jmodel, params, tmodel, batch = _arch_setup("mixtral-8x22b")
    cfg = jopt.OptimizerConfig(lr=1e-3, total_steps=4)
    tcfg = topt.OptimizerConfig(**dataclasses.asdict(cfg))
    jfn = jax.jit(jstep.make_train_step(jmodel, cfg, n_micro))
    tfn = tstep.make_train_step(tmodel, tcfg, n_micro)
    jp, jst = params, jopt.init_opt_state(params["lora"])
    tp = to_torch(params, "cpu")
    tst = topt.init_opt_state(tp["lora"])
    for step in range(2):
        b = jdata.make_batch(jdata.DataConfig(
            seq_len=16, global_batch=4, vocab=jcfg.vocab, seed=7), step)
        jp, jst, jm = jfn(jp, jst, to_j(b))
        tp, tst, tm = tfn(tp, tst, to_t(b))
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm",
                                            "loss", "lr"]
        for k in jm:
            close(tm[k], jm[k])
        # the second step's gradients carry the first update's near-eps
        # entries (above), so they are held to 1e-4
        close_leaves(t_leaves(tst.mu), jst.mu, GRAD_RTOL if step == 0
                     else 1e-4, f"mu {step}")
        for g, w in zip(t_leaves(tp["lora"]),
                        jax.tree_util.tree_leaves(jp["lora"])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=0.05 * cfg.lr)
        assert tp["base"] is not None and all(
            not l.requires_grad for l in topt.tree_leaves(tp["lora"]))


def test_microbatched_grads_equal_one_batch():
    """2 microbatches of 2 rows give the loss and gradients of one batch of
    4 (the accumulation is exact up to fp32 sums)."""
    _, _, params, tmodel, batch = _arch_setup("llama3.2-3b")
    tp, tb = to_torch(params, "cpu"), to_t(batch)
    l1, _, g1 = tstep._lora_grads(tmodel, tp, tb, 1)
    l2, _, g2 = tstep._lora_grads(tmodel, tp, tb, 2)
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    for x, y in zip(topt.tree_leaves(g1), topt.tree_leaves(g2)):
        assert float((x - y).abs().max()) <= 1e-5 * float(x.abs().max())


def test_eval_serve_and_prefill_steps_match_reference():
    jcfg, jmodel, params, tmodel, batch = _arch_setup("llama3.2-3b")
    tparams = to_torch(params, "cpu")
    want = jstep.make_eval_step(jmodel)(params, to_j(batch))
    got = tstep.make_eval_step(tmodel)(tparams, to_t(batch))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])
    toks = batch["tokens"][:, :8]
    jl, jc = jstep.make_prefill_step(jmodel, 12)(params,
                                                 {"tokens": jnp.asarray(toks)})
    tl, tc = tstep.make_prefill_step(tmodel, 12)(
        tparams, {"tokens": torch.from_numpy(toks)})
    atol = 2e-5 * float(np.abs(jl).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)
    nxt = toks[:, -1:]
    pos = np.full((toks.shape[0],), 8, np.int32)
    jl, _ = jstep.make_serve_step(jmodel)(params, jnp.asarray(nxt), jc,
                                          jnp.asarray(pos))
    tl, _ = tstep.make_serve_step(tmodel)(tparams, torch.from_numpy(nxt), tc,
                                          torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)


def test_trained_setup_loss_curve_matches_reference():
    """``benchmarks/common.trained_setup``'s recipe, shortened: smoke llama
    at vocab 256 pretrained full-parameter for 10 steps on task A (lr 3e-3),
    then a LoRA trained 10 steps on task B (lr 2e-3) with the base frozen;
    all 20 losses within 1e-4 relative of the reference's, and the final
    held-out CE too."""
    jcfg = dataclasses.replace(smoke_cfg("llama3.2-3b"), vocab=256)
    tcfg = dataclasses.replace(get_config("llama3.2-3b", "smoke"),
                               dtype=torch.float32, vocab=256)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = to_torch(jparams, "cpu")
    steps = 10
    jcurve, tcurve = [], []

    # --- 1. full-param pretraining on task A ---
    dc_a = jdata.DataConfig(seq_len=128, global_batch=8, vocab=256, seed=0)
    cfg_a = jopt.OptimizerConfig(lr=3e-3, total_steps=steps)
    tcfg_a = topt.OptimizerConfig(**dataclasses.asdict(cfg_a))

    @jax.jit
    def j_base_step(base, opt, batch):
        def f(b):
            return jmodel.train_loss({"base": b, "lora": jparams["lora"]},
                                     batch)[0]
        loss, g = jax.value_and_grad(f)(base)
        base, opt, _ = jopt.adamw_update(g, opt, base, cfg_a)
        return base, opt, loss

    jbase, jo = jparams["base"], jopt.init_opt_state(jparams["base"])
    tbase, to = tparams["base"], topt.init_opt_state(tparams["base"])
    for step in range(steps):
        b = jdata.make_batch(dc_a, step)
        jbase, jo, jl = j_base_step(jbase, jo, to_j(b))
        leaves = topt.tree_leaves(tbase)
        for l in leaves:
            l.requires_grad_(True)
        loss = tmodel.train_loss({"base": tbase, "lora": tparams["lora"]},
                                 to_t(b))[0]
        by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss,
                                                                leaves)))
        g = topt.tree_map(lambda l: by_leaf[id(l)], tbase)
        with torch.no_grad():
            tbase, to, _ = topt.adamw_update(g, to, tbase, tcfg_a)
        jcurve.append(float(jl))
        tcurve.append(float(loss.detach()))

    # --- 2. LoRA training on task B (frozen base) ---
    dc_b = jdata.DataConfig(seq_len=128, global_batch=8, vocab=256, seed=101)
    cfg_b = jopt.OptimizerConfig(lr=2e-3, total_steps=steps)
    jfn = jax.jit(jstep.make_train_step(jmodel, cfg_b, 1))
    tfn = tstep.make_train_step(
        tmodel, topt.OptimizerConfig(**dataclasses.asdict(cfg_b)), 1)
    jp = {"base": jbase, "lora": jparams["lora"]}
    tp = {"base": tbase, "lora": tparams["lora"]}
    jo, to = jopt.init_opt_state(jp["lora"]), topt.init_opt_state(tp["lora"])
    for step in range(steps):
        b = jdata.make_batch(dc_b, step)
        jp, jo, jm = jfn(jp, jo, to_j(b))
        tp, to, tm = tfn(tp, to, to_t(b))
        jcurve.append(float(jm["loss"]))
        tcurve.append(float(tm["loss"]))
    np.testing.assert_allclose(tcurve, jcurve, rtol=1e-4, atol=0)
    assert tcurve[-1] < tcurve[steps]      # the LoRA steps lowered the loss
    held = jdata.make_batch(dc_b, 10_000)
    close(tstep.make_eval_step(tmodel)(tp, to_t(held))["ce"],
          jstep.make_eval_step(jmodel)(jp, to_j(held))["ce"], 1e-4)
