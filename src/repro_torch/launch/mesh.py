"""Mesh construction over the launched job's ranks, and the card's
roofline denominators; port of `repro.launch.mesh`.

Functions, not module-level meshes: importing this module touches no
process group.  Every mesh is a `DeviceMesh` with the reference's axis
names over an initialised process group, one process a rank
(`launch.world.spawn_world` starts such a world).  A mesh of another
size than the world raises: nothing runs a mesh as one rank by itself.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

# Roofline denominators of one NVIDIA H100 80GB HBM3 at its 700.00 W
# power limit (NVIDIA's H100 SXM data sheet, dense rates without
# sparsity).
HBM_BW = 3.35e12  # B/s
PEAK_FLOPS_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_FLOPS_BF16 = 989e12  # FLOP/s on the tensor cores
NVLINK_BW = 900e9  # B/s a GPU, both directions, NVLink 4


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group, one "
                           "process a rank (launch.world.spawn_world)")
    return dist.get_world_size()


def _mesh(device, ranks: torch.Tensor, names: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=names)


def make_production_mesh(*, model: int | None = None, multi_pod: bool = False,
                         device=None):
    """The launched job's ranks as ``("data", "model")``, or ``("pod",
    "data", "model")`` over two pods: ``model`` ranks (default: the
    cards of one host, the NVLink domain) a model group."""
    n = _world_size()
    pods = 2 if multi_pod else 1
    if model is None:
        model = max(1, min(torch.cuda.device_count(), n // pods))
    if n % (pods * model):
        raise ValueError(f"{n} ranks do not split into {pods} pod(s) of "
                         f"model groups of {model}")
    shape = (n // (pods * model), model)
    names = ("data", "model")
    if multi_pod:
        shape, names = (pods, *shape), ("pod", *names)
    return _mesh(device, torch.arange(n).reshape(shape), names)


def make_debug_mesh(n_devices: int | None = None, model: int = 1, *,
                    device=None):
    """A ``(n // model, model)`` ``("data", "model")`` mesh over every
    rank of the world; ``n_devices`` other than the world size raises.
    ``device``: the device type of the ranks (None ⇒ the GPU)."""
    world = _world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if n % model:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model}")
    return _mesh(device, torch.arange(n).reshape(n // model, model),
                 ("data", "model"))


def make_submeshes(n: int, *, model: int = 1, device=None):
    """The world's ranks as ``n`` disjoint ``("data", "model")``
    submeshes, one a replica of a `serving.pool.ReplicaPool`: contiguous
    rank slices, data parallelism within a replica and replica
    parallelism across them (DESIGN.md §11).  Every rank builds every
    submesh (the groups are made collectively)."""
    world = _world_size()
    if world % n:
        raise ValueError(f"{world} ranks do not split into {n} submeshes")
    per = world // n
    if per % model:
        raise ValueError(f"{per} ranks a submesh do not split into model "
                         f"groups of {model}")
    return [_mesh(device, torch.arange(i * per, (i + 1) * per)
                  .reshape(per // model, model), ("data", "model"))
            for i in range(n)]


def mesh_chips(mesh) -> int:
    return int(mesh.size())
