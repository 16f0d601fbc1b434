"""Device meshes and the H100's roofline constants.

The twin of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dim names ``("data",
"model")`` or ``("pod", "data", "model")``, the JAX package's axis names and
shapes, so every spec and byte count can be held to JAX's.

- ``make_production_mesh`` builds JAX's production shapes, ``(16, 16)`` and
  ``(2, 16, 16)``, over a world of 256 / 512 ranks in this one process: the
  ``"fake"`` process-group backend, whose collectives move nothing. Only
  the dry-run uses it, on fake tensors (``launch/specs.py``).
- ``make_test_mesh`` and ``make_mesh`` build a mesh over the default process
  group the caller has initialised (gloo on the CPU, NCCL on the card),
  whose world size must equal the mesh's size.

Nothing here touches a process group or a device when it is imported.

The constants are one NVIDIA H100 SXM's (H100 80GB HBM3 at its 700 W
power limit; NVIDIA's data sheet, dense rates). A pod axis of 16 spans two
8-GPU NVLink domains, so a collective term over ``NVLINK_BW`` is a lower
bound there.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

#: the card the constants describe
CARD = "H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12        # dense bf16 / fp16 tensor-core FLOP/s
PEAK_FLOPS_INT8 = 1979e12       # dense int8 tensor-core OP/s
PEAK_FLOPS_F32 = 67e12          # f32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s
HBM_BYTES = 80e9                # the data sheet's 80 GB
NVLINK_BW = 450e9               # bytes/s per direction (NVLink 4, 18 links)
NVLINK_DOMAIN = 8               # GPUs joined all to all by NVLink

SINGLE_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def hbm_per_chip() -> int:
    """The card's memory in bytes where a card is present, else the data
    sheet's ``HBM_BYTES``."""
    import torch

    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return int(HBM_BYTES)


def init_fake_world(world_size: int) -> None:
    """Initialise this process's default group as a ``"fake"`` world of
    ``world_size`` ranks (this one is rank 0). Raises if a default group of
    another size is already initialised."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a default process group of {dist.get_world_size()} ranks "
                f"is initialised; a fake world of {world_size} needs a "
                "process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape: Sequence[int], axes: Tuple[str, ...],
              device_type: str = "cpu"):
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} for axes {axes}")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs an initialised "
                           "default process group")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs a world of {n} ranks, "
                           f"the default group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """JAX's production mesh shape over a fake world in this process:
    ``(16, 16)`` ("data", "model"), or ``(2, 16, 16)`` with a leading
    "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = POD_AXES if multi_pod else SINGLE_AXES
    init_fake_world(math.prod(shape))
    return make_mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   device_type: str = "cpu"):
    """A small mesh over the initialised default group (gloo for CPU tests,
    NCCL on the card)."""
    shape = (pod, data, model) if pod else (data, model)
    return make_mesh(shape, POD_AXES if pod else SINGLE_AXES, device_type)
