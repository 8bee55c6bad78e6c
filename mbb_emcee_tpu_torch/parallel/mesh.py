"""Device mesh construction for walker- and source-parallel sampling.

Torch twin of mbb_emcee_tpu/parallel/mesh.py: a 1-D mesh over one axis,
the walkers of one fit (parallel.ShardedEnsembleSampler) or the sources of
a batch (batchengine.BatchEngine), whose blocks are the mesh's shards in
device order."""

from __future__ import annotations

import dataclasses

import torch

from mbb_emcee_tpu_torch.fitter import resolve_device

WALKER_AXIS = "walkers"


@dataclasses.dataclass(frozen=True)
class WalkerMesh:
    """A 1-D mesh: `devices` in shard order (a device may repeat)."""
    devices: tuple

    @property
    def axis_names(self):
        return (WALKER_AXIS,)

    @property
    def size(self):
        return len(self.devices)

    @property
    def shape(self):
        return {WALKER_AXIS: self.size}


def _indexed(device):
    """A CUDA device with its index ("cuda" is the current card)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def walker_mesh(n_devices: int | None = None, devices=None) -> WalkerMesh:
    """1-D mesh over the walker axis: the first `n_devices` of `devices`
    (default: every CUDA device; without a card this raises, as every entry
    point's device=None does). An explicit `devices` list may name the CPU
    and may repeat a device (["cpu"] * 8: eight shards on the CPU)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} "
                "available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return WalkerMesh(tuple(devices))


def check_mesh(mesh):
    """`mesh` itself when it is a walker_mesh; a TypeError otherwise (a
    JAX mesh, say)."""
    if not isinstance(mesh, WalkerMesh):
        raise TypeError(
            f"mesh must be a mbb_emcee_tpu_torch.parallel.walker_mesh(); "
            f"got {type(mesh).__name__}")
    return mesh


def mesh_device(mesh, device):
    """The device an entry point with `mesh` runs its unsharded work on:
    the mesh's first device. A `device` argument that names another is
    refused."""
    first = check_mesh(mesh).devices[0]
    if device is not None and _indexed(resolve_device(device)) != first:
        raise ValueError(
            f"device={device!r} conflicts with the mesh, whose first device "
            f"is {first}; leave device unset with mesh=")
    return first


def mesh_token(mesh):
    """Content key of a mesh (None without one), written into checkpoints
    and files: the axis names, the shape and the devices in order."""
    if mesh is None:
        return None
    return (mesh.axis_names, (mesh.size,),
            tuple(str(d) for d in mesh.devices))


def mesh_blocks(mesh, nsources):
    """[(lo, hi, device)] of a source axis of `nsources` split into
    mesh.size contiguous blocks, one per shard in mesh order; the mesh size
    must divide it."""
    k = check_mesh(mesh).size
    if nsources % k:
        raise ValueError(
            f"the mesh size ({k} devices) must divide nsources={nsources}; "
            f"pad the source batch to a multiple of {k}")
    m = nsources // k
    return [(d * m, (d + 1) * m, dev) for d, dev in enumerate(mesh.devices)]
