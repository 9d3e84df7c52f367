"""Mesh definitions for the port: a port of ``repro/launch/mesh.py``.

Functions, never module-level meshes: importing this module starts no
process group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(``make_mesh``, ``make_local_mesh``, ``make_production_mesh``) or, where
no device or process group is needed (``param_specs`` and
``default_rules`` read only axis names and sizes), an ``AbstractMesh``.
``mesh_shape`` gives either one's {axis name: size} mapping, which the
reference reads as ``mesh.shape``.

A process has one default process group: a real one (``nccl`` on the
card, ``gloo`` on the CPU) or the ``fake`` one of
``make_production_mesh``, never both. So a dry-run on the production
mesh runs in a process of its own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

# H100 SXM per-card model for the roofline analysis: NVIDIA's data-sheet
# figures (dense bf16 tensor-core rate, HBM3 bandwidth, NVLink 4 bandwidth
# each way), not measurements
PEAK_BF16_FLOPS = 989e12     # FLOP/s
HBM_BW = 3.35e12             # bytes/s
ICI_BW = 450e9               # bytes/s per card over NVLink, each way


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices and no process group, as JAX's
    ``AbstractMesh``."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_abstract_mesh(axis_shapes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_names), tuple(axis_shapes))


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> tuple:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def make_mesh(axis_shapes, axis_names, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` over the default process group.

    With no process group and a mesh of one device it starts a world of
    one on an in-process store (``nccl`` for ``cuda``, ``gloo`` for
    ``cpu``): no address, no network. A larger mesh needs a group its
    caller started. A mesh larger than the group raises, as
    ``jax.make_mesh`` does with too few devices."""
    n = math.prod(axis_shapes)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no GPU is visible; pass "
                               "device_type='cpu' to build a CPU mesh")
        if n > torch.cuda.device_count():
            raise ValueError(f"make_mesh: mesh {tuple(axis_shapes)} needs "
                             f"{n} devices, {torch.cuda.device_count()} "
                             f"visible")
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"make_mesh: mesh {tuple(axis_shapes)} needs "
                             f"{n} ranks, and no process group is started")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"make_mesh: mesh {tuple(axis_shapes)} needs {n} "
                         f"ranks, the process group has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(tuple(axis_shapes)),
                      mesh_dim_names=tuple(axis_names))


FAKE_WORLD = 512           # ranks of the fake group: the multi-pod mesh


def make_fake_mesh(axis_shapes, axis_names):
    """A ``DeviceMesh`` of ``axis_shapes`` on the ``fake`` backend
    (``FakeStore``, ``FAKE_WORLD`` ranks, this process rank 0), for
    tensors on ``meta``: collectives return at once and move nothing, so a
    dry-run traces a mesh of any size in one process, as the reference
    forces 512 host devices. The group is started at the first call."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"make_fake_mesh: this process already has a "
                f"{dist.get_backend()} group; a dry-run runs in a process "
                f"of its own")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=FAKE_WORLD)
    return make_mesh(axis_shapes, axis_names, device_type="cpu")


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod, on the
    fake group (``make_fake_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """Small mesh over the visible devices (the card's, or the process
    group's ranks on the CPU); ``data`` is clamped to what fits, as in
    the reference, ``model`` is not."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh: no GPU is visible; pass "
                               "device_type='cpu' to build a CPU mesh")
        n = torch.cuda.device_count()
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, n // model) or 1
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)
