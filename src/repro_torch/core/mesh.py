"""Small 1-D data mesh for sharded query execution, in one process.

The reference runs a sharded query as one program under `shard_map` over
a 1-D device mesh.  The port runs the same eager staged walk once per
shard, each in a Python thread of its own, on that shard's block of the
partitioned inputs.  The collectives meet at a rendezvous (`ShardGroup`:
a barrier and one slot per shard) and combine in rank order, so every
shard gets bit-identical outputs (the reference's `out_specs=P()`
contract).  Every collective stays on the device: a slot holds the
shard's tensor, and a combine reads the others' tensors where they are.

`Settings.shards`: 1 = one device, no mesh (nothing here is touched); 0
= every visible device; n > 1 = exactly n (an error when fewer are
visible: silently running another mesh shape would change the plan-cache
key and the per-shard capacities).

Visible devices: every CUDA device for `cuda`, one for `cpu`.  After
`virtual_devices(device, n)`, n slots on that one device: the port's
counterpart of the reference's
`--xla_force_host_platform_device_count` (`tests/conftest.py`), which
the port's tests and `chip_smoke.py` use.  `resolve_shards` asks about
the device it is given (`optimize(..., device=)`, `CompiledQuery`,
`PlanCache`), else the default one: the card when there is one, else
the CPU.
"""
from __future__ import annotations

import contextlib
import threading

import torch

AXIS = "data"
# how long a shard waits at a collective for the others: far beyond any
# staged walk, so it only fires when a shard is stuck
_BARRIER_TIMEOUT_S = 600.0

# device type -> (the device, its slot count): set by `virtual_devices`
_VIRTUAL: dict[str, tuple[torch.device, int]] = {}
_MESHES: dict[tuple, "DataMesh"] = {}
_LOCK = threading.Lock()


def _device(device=None) -> torch.device:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def virtual_devices(device, n: int) -> None:
    """Make `n` slots on the one `device` the visible devices of its
    type (n = 1 gives the type back its real devices)."""
    device = _device(device)
    if n < 1:
        raise ValueError(f"virtual_devices needs n >= 1, got {n}")
    with _LOCK:
        if n == 1:
            _VIRTUAL.pop(device.type, None)
        else:
            _VIRTUAL[device.type] = (device, int(n))


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh on `device`'s type may use, in rank order."""
    device = _device(device)
    with _LOCK:
        virt = _VIRTUAL.get(device.type)
    if virt is not None:
        return [virt[0]] * virt[1]
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def resolve_shards(settings, device=None) -> int:
    """Concrete shard count for `settings` (0 = every visible device)."""
    n = int(getattr(settings, "shards", 1) or 0)
    if n == 1:
        return 1
    avail = len(visible_devices(device))
    if n == 0:
        return avail
    if n > avail:
        raise ValueError(
            f"settings.shards={n} but only {avail} devices are visible "
            f"(repro_torch.core.mesh.virtual_devices(device, n) makes n "
            f"slots on one device)")
    return n


def data_mesh(n: int, device=None) -> "DataMesh":
    """1-D mesh over the first `n` visible devices, cached per device
    list."""
    devs = visible_devices(device)
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    key = tuple(str(d) for d in devs[:n])
    with _LOCK:
        got = _MESHES.get(key)
        if got is None:
            got = _MESHES[key] = DataMesh(devs[:n])
    return got


class ShardGroup:
    """One run's rendezvous: every collective deposits the shard's tensor
    in its slot, waits for all, reads every slot, and waits again before
    a slot may be overwritten.  A shard that fails aborts the barrier, so
    the others raise `BrokenBarrierError` instead of waiting forever."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.n = len(self.devices)
        self.slots: list = [None] * self.n
        self.barrier = threading.Barrier(self.n, timeout=_BARRIER_TIMEOUT_S)

    def exchange(self, rank: int, x) -> list:
        """Every shard's `x`, in rank order, each on this shard's device.
        A copy from another card runs on this thread's current stream of
        the source card, which `DataMesh.run` sets to the caller's stream
        there: the stream the producer's kernels were queued on, so the
        copy is ordered after them."""
        self.slots[rank] = x
        self.barrier.wait()
        vals = list(self.slots)
        self.barrier.wait()
        dev = self.devices[rank]
        return [v if v.device == dev else v.to(dev) for v in vals]

    def abort(self) -> None:
        self.barrier.abort()


class DataMesh:
    """n device slots; `run(fn, per_shard_inputs)` calls
    `fn(rank, group, inputs)` once per shard, each in its own thread on
    its device, and returns the results in rank order.  Every thread
    takes the caller's current stream of every mesh device (the current
    stream is thread-local in torch), so each shard's kernels and its
    copies from the other shards' devices queue on the caller's streams.  A shard that raises aborts the
    group; `run` re-raises the first error (a shard's own, not the
    broken barrier it caused elsewhere) and never hangs."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.n = len(self.devices)

    def run(self, fn, per_shard_inputs) -> list:
        if len(per_shard_inputs) != self.n:
            raise ValueError(f"{len(per_shard_inputs)} inputs for a mesh "
                             f"of {self.n}")
        group = ShardGroup(self.devices)
        streams = {d: torch.cuda.current_stream(d)
                   for d in set(self.devices) if d.type == "cuda"}
        results: list = [None] * self.n
        errors: list = [None] * self.n

        def work(rank: int) -> None:
            dev = self.devices[rank]
            try:
                with contextlib.ExitStack() as stack:
                    for stream in streams.values():
                        stack.enter_context(torch.cuda.stream(stream))
                    if dev.type == "cuda":
                        # last: setting a stream may also set its device
                        stack.enter_context(torch.cuda.device(dev))
                    results[rank] = fn(rank, group, per_shard_inputs[rank])
            except BaseException as err:   # handed to the caller below
                errors[rank] = err
                group.abort()

        threads = [threading.Thread(target=work, args=(r,),
                                    name=f"repro-shard-{r}", daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            own = [e for e in failed
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or failed)[0]
        return results
