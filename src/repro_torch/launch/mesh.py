"""Device meshes.

Production, the reference's fleet: 256 devices as (16 data, 16 model), or
512 as (2 pod, 16 data, 16 model), where "pod" is the cross-pod boundary
and the batch shards over (pod, data).  A process with no process group
builds it on ``torch.distributed``'s *fake* process group: every rank's
collectives return at once and move nothing, so with fake tensors one
process plays rank 0 of the whole fleet (the counterpart of the reference's
512 placeholder host devices).

Host: a (data, model) mesh over a real process group the caller has
initialized (NCCL on cards, gloo in the CPU tests).

Functions, not module constants: importing this module initializes
nothing.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _fake_store():
    """``FakeStore``, from a private torch module: imported here only."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the production mesh needs torch's fake process group: "
            "torch.testing._internal.distributed.fake_pg.FakeStore is not "
            f"importable in this torch installation ({e})") from e
    return FakeStore()


def production_shape(multi_pod: bool = False):
    """(mesh shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh.  With no process group yet, one is made on the
    fake backend at the mesh's world size (256 or 512), as rank 0; a group
    that exists must have that world size."""
    shape, axes = production_shape(multi_pod)
    need = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=_fake_store(), rank=0,
                                world_size=need)
    if dist.get_world_size() != need:
        raise RuntimeError(f"mesh {shape} needs a world of {need} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the initialized process group, whose world
    size must be ``data * model``."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != data * model:
        raise RuntimeError(f"mesh ({data}, {model}) needs {data * model} ranks, "
                           f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
