"""The ranks of a ``torch.distributed`` world as a ``(fed, data, model)`` mesh (``qdml_tpu/parallel/mesh.py``).

JAX places arrays on a named device mesh and XLA inserts the collectives.
The port uses PyTorch's idiom: one process a rank, started by
``python -m torch.distributed.run`` or by any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
(:func:`init_distributed`). Three logical axes, as in JAX:

- ``data``: the batch rows (data parallel; gradients reduced over the line);
- ``model``: the statevector's amplitudes (:mod:`qdml_tpu_torch.quantum.
  sharded`) and the head's output columns (tensor parallel);
- ``fed``: the scenario grid, one scenario's trunk a line
  (:mod:`qdml_tpu_torch.parallel.federated`).

A :class:`Mesh` arranges the world's ranks row-major as ``(fed, data,
model)``, as JAX reshapes its device list (``np.array(devices).reshape(fed,
data, model)``): rank ``r = (f * D + d) * M + m``. It holds this rank's
process group along each axis of size > 1. ``new_group`` is collective, so
every rank creates every group, in one order, once, in :func:`make_mesh`.
The collectives over those groups are
:mod:`qdml_tpu_torch.parallel.collectives`.

Backend: NCCL for a world on CUDA devices, gloo on the CPU.
``QDML_TORCH_DIST_BACKEND=gloo`` asks for gloo on CUDA devices, for ranks
that share one card (NCCL refuses two ranks of one communicator on one
card); gloo then moves every CUDA tensor through host memory, explicitly.
NCCL asked of ranks that share a card raises with a message that names the
variable: nothing picks a backend or a device silently. Under a world of R
ranks rank r runs on ``cuda:{LOCAL_RANK}`` unless the caller names a device.

A world of one rank is the single-device path, unchanged:
:func:`training_mesh` returns ``None`` there, as JAX's does on one device.

Serving is one process over the cards it sees, as JAX's engine is one
process over its devices: :func:`serve_mesh` lays those cards out as a
:class:`LocalMesh` (:func:`make_local_mesh`, the same ``(fed, data, model)``
rules over a list of devices in place of ranks), and the serving engine
places its weights and row slices on its positions
(:mod:`qdml_tpu_torch.serve.engine`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from qdml_tpu_torch.config import MeshConfig
from qdml_tpu_torch.utils.device import resolve_device

AXES = ("fed", "data", "model")
ENV_BACKEND = "QDML_TORCH_DIST_BACKEND"
# a rank that dies fails the others at their next collective instead of
# hanging them
DEFAULT_TIMEOUT_S = 60.0

# the mesh the trainers built, read by the circuit dispatch
# (autotune.model_axis_devices, sharded.run_circuit_sharded)
_CURRENT: "Mesh | None" = None
# meshes already built, by layout: new_group is collective, so a layout is
# built once and every later call on every rank returns the same groups
_BUILT: dict[tuple[int, int, int], "Mesh"] = {}


def world_size() -> int:
    """Ranks of the live world; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the live world; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def dist_backend(device: str | torch.device) -> str:
    """The backend of a world whose ranks run on ``device``'s type: gloo on
    the CPU, NCCL on CUDA unless ``QDML_TORCH_DIST_BACKEND`` says gloo."""
    want = os.environ.get(ENV_BACKEND, "").strip().lower()
    if want not in ("", "gloo", "nccl"):
        raise ValueError(f"{ENV_BACKEND}={want!r}; want gloo or nccl")
    if torch.device(device).type == "cpu":
        if want == "nccl":
            raise ValueError(f"{ENV_BACKEND}=nccl moves CUDA tensors only; a world on the CPU runs gloo")
        return "gloo"
    return want or "nccl"


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``device`` when the caller names one, else
    ``cuda:{LOCAL_RANK}`` (raises without a card, as
    :func:`~qdml_tpu_torch.utils.device.resolve_device` does)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_distributed(
    device: str | torch.device | None = None, timeout_s: float = DEFAULT_TIMEOUT_S
) -> torch.device:
    """Join the world the launcher's environment describes, on this rank's
    device (:func:`rank_device`), and return the device. A no-op returning
    the device when the environment names no world of several ranks or the
    world is already live. The backend is :func:`dist_backend`'s; NCCL for
    ranks that share one card raises. A failed rendezvous raises
    (:func:`~qdml_tpu_torch.parallel.multihost.ensure_initialized`)."""
    from qdml_tpu_torch.parallel.multihost import ensure_initialized

    dev = rank_device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return dev
    backend = dist_backend(dev)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if local > 1 and (device is not None or local > torch.cuda.device_count()):
            cards = dev if device is not None else f"{torch.cuda.device_count()} visible card(s)"
            raise RuntimeError(
                f"NCCL cannot run two ranks of one communicator on one card: {local} local ranks "
                f"share {cards}; set {ENV_BACKEND}=gloo to exchange through host memory, "
                "or give each rank a card of its own"
            )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ensure_initialized(backend=backend, timeout_s=timeout_s)
    return dev


def leave_world(sync: bool = True) -> None:
    """Tear the world down (its process groups and the meshes built over
    them), with ``sync`` once every rank got here (a failing rank leaves
    without waiting for the others); a no-op without a world."""
    global _CURRENT
    if dist.is_available() and dist.is_initialized():
        if sync:
            dist.barrier()
        dist.destroy_process_group()
    _CURRENT = None
    _BUILT.clear()


@dataclass
class Mesh:
    """A ``(fed, data, model)`` layout of ranks, and this rank's place in it.

    ``shape`` maps each axis to its size (JAX's ``mesh.shape``); ``devices``
    is the ``(F, D, M)`` array of ranks (JAX's ``mesh.devices``, ranks in
    place of devices); ``rank`` this process's rank, ``device`` its device,
    ``backend`` the world's (``None`` for a layout with no live world).
    :meth:`group` is this rank's process group along an axis."""

    shape: dict[str, int]
    rank: int
    device: torch.device
    backend: str | None = None
    _groups: dict[str, Any] = field(default_factory=dict, repr=False)

    axis_names = AXES

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.size).reshape(tuple(self.shape[a] for a in AXES))

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    @property
    def member(self) -> bool:
        """Whether this rank lies on the mesh (a world may hold more ranks)."""
        return self.rank < self.size

    def coords(self) -> dict[str, int]:
        """This rank's ``{"fed": f, "data": d, "model": m}``."""
        if not self.member:
            raise ValueError(f"rank {self.rank} lies outside the {self.size}-rank mesh")
        idx = np.unravel_index(self.rank, tuple(self.shape[a] for a in AXES))
        return {a: int(i) for a, i in zip(AXES, idx)}

    def coord(self, axis: str) -> int:
        return self.coords()[axis]

    def group_ranks(self, axis: str) -> list[int]:
        """The ranks of this rank's line along ``axis``, in axis order."""
        c = self.coords()
        sl = tuple(slice(None) if a == axis else c[a] for a in AXES)
        return self.devices[sl].tolist()

    def group(self, axis: str):
        """This rank's process group along ``axis``; ``None`` for an axis of
        size 1, where every collective is the identity. A layout built
        without a live world has no groups and raises."""
        if self.shape[axis] == 1:
            return None
        if axis not in self._groups:
            raise RuntimeError(f"mesh {self.shape} has no live process group along {axis!r}")
        return self._groups[axis]


def make_mesh(
    cfg: MeshConfig | None = None,
    world: int | None = None,
    rank: int | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """The ``(fed, data, model)`` mesh over the live world (JAX's rules:
    ``data_axis=-1`` takes every rank left after the model and fed axes; a
    layout needing more ranks than the world has raises), with this rank's
    group along each axis. ``world`` and ``rank`` given instead lay the mesh
    out for a world that is not live, with no groups (a layout only)."""
    cfg = cfg or MeshConfig()
    live = world is None
    n = world_size() if live else int(world)
    model = max(cfg.model_axis, 1)
    fed = max(cfg.fed_axis, 1)
    data = max(n // (model * fed), 1) if cfg.data_axis == -1 else max(cfg.data_axis, 1)
    need = fed * data * model
    if need > n:
        raise ValueError(f"mesh {fed}x{data}x{model} needs {need} devices, have {n}")
    r = world_rank() if rank is None else int(rank)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    shape = {"fed": fed, "data": data, "model": model}
    if not (live and n > 1):
        return Mesh(shape, r, dev)
    key = (fed, data, model)
    if key in _BUILT:
        return _BUILT[key]
    mesh = Mesh(shape, r, dev, backend=dist.get_backend())
    grid = mesh.devices
    for i, axis in enumerate(AXES):
        if grid.shape[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]).tolist():
            g = dist.new_group(line)  # every rank, every line, this order
            if r in line:
                mesh._groups[axis] = g
    _BUILT[key] = mesh
    return mesh


def training_mesh(cfg, device: str | torch.device | None = None) -> Mesh | None:
    """The trainers' mesh over the live world, or ``None`` for a world of
    one rank (``qdml_tpu/parallel/mesh.py:66-93``, its checks and messages):
    the axis names are fixed, and a fed axis > 1 must equal the scenario
    count. Batch divisibility is the grid placer's to judge
    (:func:`~qdml_tpu_torch.parallel.multihost.make_grid_placer`). The mesh
    becomes the process's current mesh (:func:`current_mesh`), which the
    circuit dispatch reads."""
    global _CURRENT
    names = (cfg.mesh.fed_axis_name, cfg.mesh.data_axis_name, cfg.mesh.model_axis_name)
    if names != ("fed", "data", "model"):
        raise ValueError(
            f"mesh axis names are fixed to ('fed', 'data', 'model'); got {names} — "
            "the sharding specs in qdml_tpu.parallel use the names literally"
        )
    if world_size() == 1:
        return None
    mesh = make_mesh(cfg.mesh, device=rank_device(device))
    fed = mesh.shape[cfg.mesh.fed_axis_name]
    if fed > 1 and fed != cfg.data.n_scenarios:
        raise ValueError(
            f"mesh fed axis ({fed}) must equal data.n_scenarios "
            f"({cfg.data.n_scenarios}) to shard the scenario grid"
        )
    _CURRENT = mesh
    return mesh


def current_mesh() -> Mesh | None:
    """The mesh :func:`training_mesh` built last in this process, if any."""
    return _CURRENT


@dataclass
class LocalMesh:
    """A ``(fed, data, model)`` layout of the devices one process sees: the
    serving engine's mesh. ``shape`` maps each axis to its size (JAX's
    ``mesh.shape``); ``devices`` is the ``(F, D, M)`` array of
    ``torch.device``, row-major as JAX's ``np.array(devices).reshape(fed,
    data, model)`` (``qdml_tpu/parallel/mesh.py:61``). A device may stand at
    several positions (logical positions on one card, as JAX's virtual CPU
    devices), but only an explicit :func:`make_local_mesh` call lays one out
    so; :func:`serve_mesh` never repeats a card."""

    shape: dict[str, int]
    devices: np.ndarray

    axis_names = AXES

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, fed: int = 0, data: int = 0, model: int = 0) -> torch.device:
        """The device at position ``(fed, data, model)``."""
        return self.devices[fed, data, model]

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in position order."""
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def make_local_mesh(cfg: MeshConfig | None, devices) -> LocalMesh:
    """The ``(fed, data, model)`` mesh over ``devices`` (JAX's ``make_mesh``
    rules and message: ``data_axis=-1`` takes every device left after the
    model and fed axes; a layout needing more devices than given raises)."""
    cfg = cfg or MeshConfig()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    model = max(cfg.model_axis, 1)
    fed = max(cfg.fed_axis, 1)
    data = max(n // (model * fed), 1) if cfg.data_axis == -1 else max(cfg.data_axis, 1)
    need = fed * data * model
    if need > n:
        raise ValueError(f"mesh {fed}x{data}x{model} needs {need} devices, have {n}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return LocalMesh({"fed": fed, "data": data, "model": model}, grid.reshape(fed, data, model))


def serve_mesh(cfg, device: str | torch.device | None = None) -> LocalMesh | None:
    """Mesh for the serving engine, or ``None`` for the single-device layout
    (``qdml_tpu/parallel/mesh.py:96-140``, its checks and messages).
    ``serve.shard="auto"`` (default) lays the mesh over every visible card
    (``cuda:0 .. cuda:N-1``) when more than one is visible; ``"off"`` pins
    the single-device layout. ``device`` names the platform: the CPU, or a
    card with an index, is one device. Expert sharding
    (``serve.expert_sharding``) needs the fed axis to equal the scenario
    count. One process serves over the cards it sees: under a world of
    several ranks this raises."""
    if cfg.serve.shard not in ("auto", "off"):
        raise ValueError(f"serve.shard must be 'auto' or 'off', got {cfg.serve.shard!r}")
    if cfg.serve.shard == "off":
        if cfg.serve.expert_sharding:
            # contradictory on its face: never silently un-shard the experts
            raise ValueError(
                "serve.expert_sharding=true requires sharding: remove "
                "serve.shard='off' (or drop expert_sharding)"
            )
        return None
    if world_size() > 1:
        raise NotImplementedError(
            f"serving under a world of {world_size()} ranks: one process serves over the "
            "cards it sees (serve.shard=auto lays them out as the serving mesh), as the JAX "
            "package's engine serves from one process over its devices; start serve or "
            "loadgen without a launcher"
        )
    names = (cfg.mesh.fed_axis_name, cfg.mesh.data_axis_name, cfg.mesh.model_axis_name)
    if names != AXES:
        raise ValueError(
            f"mesh axis names are fixed to ('fed', 'data', 'model'); got {names} — "
            "the sharding specs in qdml_tpu.parallel use the names literally"
        )
    dev = torch.device(device) if device is not None else torch.device("cuda")
    visible = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    if visible <= 1:
        if cfg.serve.expert_sharding:
            # portable configs run on laptops too: degrade loudly, not
            # silently (the single visible device serves every expert)
            print(
                "note: serve.expert_sharding requested but only one device "
                "is visible — serving single-device, experts unsharded"
            )
        return None
    mesh = make_local_mesh(cfg.mesh, [torch.device("cuda", i) for i in range(visible)])
    fed = mesh.shape["fed"]
    if fed > 1 and fed != cfg.data.n_scenarios:
        raise ValueError(
            f"mesh fed axis ({fed}) must equal data.n_scenarios "
            f"({cfg.data.n_scenarios}) to shard the scenario grid"
        )
    if cfg.serve.expert_sharding and fed != cfg.data.n_scenarios:
        raise ValueError(
            f"serve.expert_sharding needs mesh.fed_axis == data.n_scenarios "
            f"({cfg.data.n_scenarios}); the mesh has fed={fed}"
        )
    return mesh


def single_device_mesh(device: str | torch.device | None = None) -> Mesh:
    """The 1x1x1 mesh of one rank (``qdml_tpu/parallel/mesh.py:143``)."""
    return make_mesh(MeshConfig(data_axis=1), world=1, rank=0, device=device)
