"""Meshes for the model-sharding layer: the production meshes of the
dry run, the model mesh of the launchers, and the worlds they live in.

The port of `repro/launch/mesh.py`.  A `DeviceMesh` needs a process
group of as many ranks as it has devices.  `world(n, kind)` opens one of
n ranks in this one process and closes it on exit:

- `"fake"`: PyTorch's `fake` backend, whose collectives move nothing.
  The dry run traces over it under `FakeTensorMode`, so a DTensor holds
  rank 0's shard as a fake tensor and nothing is allocated: the
  counterpart of the reference's `--xla_force_host_platform_device_count
  =512` with `.lower().compile()`.
- `"local"`: the same backend under `LocalTensorMode(n)`: every rank's
  shard is a real tensor, all of them on the one device, and each
  collective is computed from them.  These are virtual slots of one
  device (`repro_torch.core.mesh.virtual_devices`), the counterpart of
  the reference's forced host devices.

In both, plain tensors met beside DTensors (positions, masks) count as
replicated (`implicit_replication`).

`make_production_mesh(multi_pod)` is the reference's (16, 16)
("data", "model") mesh of 256 ranks, or (2, 16, 16) with "pod" ahead
(512).  `model_mesh(device)` is the launchers' mesh
(`build_mesh_or_none` of `repro/launch/train.py`): none on one device;
on n virtual slots of one device a local world with the reference's
(n // model, model) factorisation; on several cards a real NCCL world,
one process a card, whose rank and size come from the environment
(`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, as `torchrun` sets
them).  The last branch has not run: no run has had two cards.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.models.sharding import Ctx

PROD_AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


class _Store(dist.Store):
    """The fake backend exchanges nothing, so its store holds nothing."""


def _fake_backend(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup

    return FakeProcessGroup._create_internal(
        common_opts.group_rank, common_opts.group_size, backend_opts)


def _register_fake() -> None:
    if "FAKE" not in dist.Backend._plugins:
        dist.Backend.register_backend("fake", _fake_backend,
                                      extended_api=True,
                                      devices=["cpu", "cuda"])


def _close_fake_world() -> None:
    """Close a fake world left open (by a test that failed before its
    exit, say); a real one is the caller's and is refused."""
    if not dist.is_initialized():
        return
    if dist.get_backend() != "fake":
        raise RuntimeError(
            f"a {dist.get_backend()} process group is open; the model "
            "mesh's world cannot be opened beside it")
    dist.destroy_process_group()


@contextlib.contextmanager
def world(n: int, kind: str = "local"):
    """A world of `n` ranks in this process, `"fake"` or `"local"`."""
    if kind not in ("fake", "local"):
        raise ValueError(f"world kind {kind!r}: 'fake' or 'local'")
    _register_fake()
    _close_fake_world()
    dist.init_process_group("fake", rank=0, world_size=n, store=_Store())
    try:
        from torch.distributed.tensor.experimental import \
            implicit_replication

        with implicit_replication():
            if kind == "local":
                from torch.distributed._local_tensor import LocalTensorMode

                with LocalTensorMode(n):
                    yield
            else:
                yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A `DeviceMesh` of `shape` named `axes` over the open world."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} devices, have {have} — open a world of {n} ranks "
            "(repro_torch.launch.mesh.world) before building the mesh")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    if multi_pod:
        return make_mesh((2, 16, 16), POD_AXES, device_type)
    return make_mesh((16, 16), PROD_AXES, device_type)


def make_ctx(mesh) -> Ctx:
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    return Ctx(mesh=mesh, dp_axes=dp, tp_axis="model")


def factor(n: int) -> tuple[int, int]:
    """The reference's (data, model) split of n devices: the largest of
    16, 8, 4, 2 that divides n goes to `model`."""
    model = next((c for c in (16, 8, 4, 2) if n % c == 0), 1)
    return n // model, model


@contextlib.contextmanager
def model_mesh(device):
    """The launchers' model mesh on `device`'s visible devices (None on
    one device), open for the `with` block."""
    from repro_torch.core.mesh import visible_devices

    device = torch.device(device)
    devs = visible_devices(device)
    if len(devs) == 1:
        yield None
        return
    shape = factor(len(devs))
    if all(d == devs[0] for d in devs):
        with world(len(devs), "local"):
            yield make_mesh(shape, PROD_AXES, devs[0].type)
        return
    from torch.distributed.device_mesh import init_device_mesh

    # one process a card (torchrun): the default group from the
    # environment; never run (no machine here has had two cards)
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=PROD_AXES)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()

