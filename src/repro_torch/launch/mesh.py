"""Production mesh construction, the JAX package's ``launch/mesh.py`` over
``torch.distributed``.

A mesh is a ``DeviceMesh`` with named dims: ``(16, 16)`` over ``("data",
"model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")`` for two
pods. Building one needs a default process group of as many ranks as the
mesh has devices. The dry run has no such cluster: it runs in one process
over a *fake* group (:func:`fake_world`), whose collectives never leave
the process, so a 256- or 512-rank mesh can be built on any machine.

These are functions: importing the module touches nothing of
``torch.distributed``.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes``, over the
    default process group (which must have ``prod(shape)`` ranks)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} devices needs a process group of "
                           f"{n} ranks (fake_world({n}) in one process)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` fake ranks in this
    process (backend ``"fake"`` over a ``FakeStore``: no network, no
    peers), torn down on exit. A process holds one default group at a
    time, so one ``fake_world`` runs at a time."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
