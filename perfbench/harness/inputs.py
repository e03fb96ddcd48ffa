"""What the benchmark draws from ``--seed`` and hands to both sides.

* the base weights' seed (both sides draw the weights from it themselves);
* each adapter's float LoRA factors, drawn per adapter from a seed of its
  own, so that the reference can draw again just the adapters it checks;
* the adapters' popularity and the requests (``traffic.py``).

The factors imitate a trained adapter: Gaussian, with rank components that
decay like ``exp(-0.3 i)``, the regime in which LoRAQuant's split has
something to split.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from reference.weights import attention_shapes, dims, ffn_shapes

FACTOR_SCALE = 0.02
SPECTRUM_DECAY = 0.3
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def adapter_seed(seed: int, index: int) -> int:
    """The generator seed of adapter ``index`` under run seed ``seed``."""
    return ((seed * _MIX) ^ (index + 1) * 0xBF58476D1CE4E5B9) & _MASK


def linears(cfg: Dict[str, Any]) -> List[Tuple[str, str, tuple, int, int]]:
    """Every LoRA linear of a configuration, in the model's order: ``(path
    in the program's LoRA tree, reference name, lead dims, in, out)``."""
    n = dims(cfg)
    lead = (n["layers"],)
    out = [(f"/groups/0/sub_0/mixer/{name}", name, lead, i, o)
           for name, (i, o) in attention_shapes(n).items()]
    if "e" in n:
        out.append(("/groups/0/sub_0/ffn/router", "router", lead, n["d"],
                    n["e"]))
        out += [(f"/groups/0/sub_0/ffn/experts/{name}", "x" + name,
                 lead + (n["e"],), i, o)
                for name, (i, o) in ffn_shapes(n).items()]
    else:
        out += [(f"/groups/0/sub_0/ffn/{name}", name, lead, i, o)
                for name, (i, o) in ffn_shapes(n).items()]
    return out


def adapter_factors(cfg: Dict[str, Any], seed: int, index: int,
                    device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adapter ``index``'s fp32 factors, path → ``{"a" (*lead, r, in),
    "b" (*lead, out, r)}``, from one normal draw on ``device``."""
    r = cfg["lora_rank"]
    specs = linears(cfg)
    sizes = []
    for _, _, lead, i, o in specs:
        m = 1
        for x in lead:
            m *= x
        sizes += [m * r * i, m * o * r]
    gen = torch.Generator(device=device)
    gen.manual_seed(adapter_seed(seed, index))
    buf = torch.randn(sum(sizes), generator=gen, device=device)
    buf.mul_(FACTOR_SCALE)
    decay = torch.exp(-SPECTRUM_DECAY * torch.arange(
        r, dtype=torch.float32, device=device))
    out, off = {}, 0
    for (path, _, lead, i, o), (na, nb) in zip(specs, zip(sizes[::2],
                                                          sizes[1::2])):
        a = buf[off:off + na].view(lead + (r, i))
        off += na
        b = buf[off:off + nb].view(lead + (o, r))
        off += nb
        a.mul_(decay[:, None])
        b.mul_(decay)
        out[path] = {"a": a, "b": b}
    return out


def nest(flat: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """Path-keyed leaves as the program's nested LoRA tree."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = [p for p in path.split("/") if p]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    groups = tree.pop("groups")
    return {"groups": [groups[k] for k in sorted(groups, key=int)]}
