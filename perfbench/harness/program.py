"""The system under test: the PyTorch port, built from a configuration file.

This is the only module of the harness that imports the program. It maps a
``configs/*.json`` file onto the port's model configuration, and builds what
``repro_torch.launch.serve`` builds: the model with its weights drawn on the
device, an ``AdapterStore`` that quantizes the fleet, and a
``MultiLoRAEngine`` in continuous mode with a ``Telemetry``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import BlockSpec
from repro_torch.core import LoRAQuantConfig
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.serving.engine import AdapterStore, MultiLoRAEngine, Request
from repro_torch.serving.telemetry import Telemetry

from reference.weights import DTYPES, dims

__all__ = ["Model", "Request", "port_config", "build", "make_store", "make_engine"]

# the port's RMSNorm epsilon (repro_torch/models/common.py), which every
# configuration file has to state
PORT_RMS_EPS = 1e-6


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration file: the arch's own,
    with every size the file gives."""
    if float(cfg["rms_norm_eps"]) != PORT_RMS_EPS:
        raise ValueError(f"{cfg['name']}: the port's RMSNorm epsilon is "
                         f"{PORT_RMS_EPS}, the file says "
                         f"{cfg['rms_norm_eps']}")
    n = dims(cfg)
    base = get_config(cfg["arch"], "full")
    kw = dict(n_layers=n["layers"], d_model=n["d"], n_heads=n["h"],
              n_kv_heads=n["kv"], head_dim=n["dh"], d_ff=n["f"],
              vocab=n["v"], rope_theta=float(cfg["rope_theta"]),
              lora_rank=n["r"], lora_alpha=float(cfg["lora_alpha"]),
              dtype=DTYPES[cfg["dtype"]],
              blocks=(BlockSpec(count=n["layers"],
                                pattern=base.blocks[0].pattern,
                                ffn=base.blocks[0].ffn),))
    window = cfg.get("assumed", {}).get("window")
    if window is not None:
        kw["window"] = int(window)
    if "e" in n:
        kw["moe"] = dataclasses.replace(
            base.moe, n_experts=n["e"], top_k=n["k"], d_ff_expert=n["f"],
            capacity_factor=float(cfg["assumed"]["capacity_factor"]))
    return dataclasses.replace(base, **kw)


def build(cfg: Dict[str, Any], seed: int, device):
    """``(model, params)``: the weights drawn by the program's own init."""
    model = build_model(port_config(cfg))
    return model, model.init(seed=seed, device=device)


def make_store(recipe: str) -> AdapterStore:
    bits, rho = recipe.split("@")
    return AdapterStore(LoRAQuantConfig(bits_high=int(bits), rho=float(rho)))


def make_engine(model, params, store, eng: Dict[str, Any]):
    telemetry = Telemetry()
    engine = MultiLoRAEngine(model, params, store,
                             cache_capacity=int(eng["cache_capacity"]),
                             mode="continuous", max_rows=int(eng["max_rows"]),
                             hbm_slots=eng.get("slots"), telemetry=telemetry)
    return engine, telemetry
