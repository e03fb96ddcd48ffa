"""The frozen reference against the port's eager path at smoke size: the
drawn weights, the adapters' codes, and logits through prefill and decode,
dense and with experts."""

import pytest
import torch

import smoke
from harness import inputs, program
from reference import loraquant as rq
from reference import model as rm
from reference import weights as rw
from repro_torch.serving.engine import iter_lora_linears

from harness.check import _program_factors, _side


@pytest.mark.parametrize("name", ["internlm2-20b", "mixtral-8x22b-l8"])
def test_weights_codes_and_logits(name):
    cfg = smoke.smoke_config(name)
    if cfg.get("num_local_experts"):
        # drop-free: the capacity rule is the check's own number
        cfg["assumed"] = dict(cfg["assumed"], capacity_factor=32.0)
    model, params = program.build(cfg, 5, "cpu")
    ref = rw.draw(cfg, 5, "cpu")
    assert torch.equal(params["base"]["embed"]["e"], ref["embed"])
    assert torch.equal(params["base"]["head"]["e"], ref["head"])
    flat = inputs.adapter_factors(cfg, 5, 2, "cpu")
    assert {p for p, _ in iter_lora_linears(params["lora"])} == set(flat)

    store = program.make_store("2@0.9")
    store.register_many({"a2": inputs.nest(flat)})
    mine = {}
    r = cfg["lora_rank"]
    for path, name_, lead, i, o in inputs.linears(cfg):
        n = 1
        for x in lead:
            n *= x
        q = rq.quantize(flat[path]["b"].reshape(n, o, r),
                        flat[path]["a"].reshape(n, r, i), 2, 0.9)
        mine[name_] = [(b, a) for b, a, _ in q]
        prog = store.quantized["a2"].entries[path]
        for qq, (b, a) in zip(prog, mine[name_]):
            p = _program_factors([_side(s) for s in (
                qq.b_high, qq.a_high, qq.b_low, qq.a_low)])
            assert rq.delta_gap(p, (b, a)) < 1e-6

    # prefill then decode through the program, every position's logits
    toks = torch.randint(0, cfg["vocab_size"], (1, 11),
                         generator=torch.Generator().manual_seed(1))
    lora = {"groups": params["lora"]["groups"]}
    tree = inputs.nest({p: {"a": a, "b": b} for p, (a, b) in (
        (p, (v["a"], v["b"])) for p, v in _dequant(cfg, store).items())})
    pp = {"base": params["base"], "lora": tree}
    logits, caches = model.prefill(pp, {"tokens": toks[:, :7]}, 32)
    steps = [logits[0]]
    for t in range(7, 11):
        lg, caches = model.decode_step(pp, toks[:, t:t + 1], caches,
                                       torch.tensor([t]))
        steps.append(lg[0])
    got = torch.cat(steps)
    want = rm.Forward(cfg, ref).logits(toks[0].tolist(), mine)
    assert (got[: want.shape[0]] - want).abs().max() <= 1e-4 * \
        want.abs().max()
    del lora


def _dequant(cfg, store):
    """The program's adapter as float factors of the template's shapes."""
    out = {}
    qa = store.quantized["a2"]
    r = cfg["lora_rank"]
    for path, _, lead, i, o in inputs.linears(cfg):
        bs, as_ = [], []
        for qq in qa.entries[path]:
            b, a = _program_factors([_side(s) for s in (
                qq.b_high, qq.a_high, qq.b_low, qq.a_low)])
            bs.append(torch.nn.functional.pad(b, (0, r - b.shape[1])))
            as_.append(torch.nn.functional.pad(a, (0, 0, 0,
                                                   r - a.shape[0])))
        out[path] = {"a": torch.stack(as_).reshape(lead + (r, i)),
                     "b": torch.stack(bs).reshape(lead + (o, r))}
    return out
