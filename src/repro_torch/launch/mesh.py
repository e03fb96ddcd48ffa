"""Meshes (port of ``repro/launch/mesh.py``).

``make_production_mesh`` is the reference's production layout by axis names
and sizes (:class:`~repro_torch.parallel.sharding.AbstractMesh`): it touches
no device and starts no process, so the sharding rules can be read at
(16, 16) and (2, 16, 16) anywhere.

``make_host_mesh`` is what this host has: it starts the process group
(NCCL on the card, gloo with ``device="cpu"``) and returns a
:class:`HostMesh` over ``init_device_mesh(device, (1, world), ("data",
"model"))``, the reference's ``(1, n)`` layout. :func:`mesh_over` lays
any shape over a process group that is already up: ``(d, m)`` over ``d·m``
gloo ranks in the tests, ``(16, 16)`` / ``(2, 16, 16)`` over the fake
backend in the dry run. Under ``torchrun`` it
joins the job the environment names; alone it is world size 1 over an
in-process store (no port). :meth:`HostMesh.close` tears the group down,
so a later caller can start one again.

Axes:
* ``data``  — batch / FSDP axis
* ``model`` — tensor/expert parallel axis
* ``pod``   — the cross-pod axis of the multi-pod layout; specs treat
  ``("pod", "data")`` as one combined FSDP axis.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.parallel.sharding import AbstractMesh, fsdp_axes

__all__ = ["HostMesh", "make_host_mesh", "make_production_mesh",
           "mesh_over"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


class HostMesh:
    """A torch ``DeviceMesh`` with the attributes the sharding rules and
    the model read: ``axis_names``, ``shape`` (name → size), ``coords``
    (name → this rank's coordinate), :meth:`fsdp_group` and
    :meth:`model_group`."""

    def __init__(self, device_mesh, owns_group: bool = False):
        self.device_mesh = device_mesh
        self.owns_group = owns_group
        self._fsdp = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def coords(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def fsdp_group(self):
        """The process group along the FSDP axes: ``data``, or ``("pod",
        "data")`` flattened in row-major order (the order of a
        ``PartitionSpec`` entry naming both)."""
        if self._fsdp is None:
            fa = fsdp_axes(self)
            if not fa:
                raise ValueError(f"mesh {self.axis_names} has no FSDP axis")
            self._fsdp = (self.device_mesh.get_group(fa[0]) if len(fa) == 1
                          else self.device_mesh[fa]._flatten().get_group())
        return self._fsdp

    def model_group(self):
        """The process group along the ``model`` axis."""
        return self.device_mesh.get_group("model")

    def close(self):
        """Destroy the process group if :func:`make_host_mesh` started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def make_host_mesh(device="cuda") -> HostMesh:
    """Whatever this host runs: the ``(1, world)`` mesh over
    ``("data", "model")``; the card unless ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    owns = not dist.is_initialized()
    if owns:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    mesh = mesh_over((1, dist.get_world_size()), device=dev)
    mesh.owns_group = owns
    return mesh


def mesh_over(shape, names=("data", "model"), device="cuda") -> HostMesh:
    """A :class:`HostMesh` of ``shape`` over the process group that is up
    (its world size must be the product of ``shape``); ranks are laid out
    row-major, as ``Mesh(devices.reshape(shape))`` lays devices out. The
    card unless ``device="cpu"`` (or ``"meta"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    dm = init_device_mesh("cpu" if dev.type == "meta" else dev.type,
                          tuple(shape), mesh_dim_names=tuple(names))
    return HostMesh(dm)
