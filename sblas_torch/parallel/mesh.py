"""Meshes of ranks over ``torch.distributed``: the port of
``sblas/parallel/mesh.py`` and of ``make_mesh_hier`` (``hier.py:40``).

The JAX package is single-controller: one process sees every chip, and a
``jax.sharding.Mesh`` names them. The port is SPMD: one process a rank,
every rank runs the same program, and a :class:`Mesh` holds what a rank
needs to take part: the world ranks laid out on named axes (the JAX
package's names and its most-square rule), this rank's place, one process
group a line of each axis (``dist.new_group``; the 2D mesh's ``rows`` and
``cols`` groups, the hierarchical mesh's ``hosts`` and ``chips`` groups),
the rank's device, the backend and why it was chosen, and the transport.

The backend rule (:func:`backend_for`): ``nccl`` where every rank on the
host has a card of its own, ``gloo`` on the CPU and where ranks share a card
(NCCL refuses two ranks on one card). On a card under ``gloo`` the
collectives stage their tensors through host memory
(:mod:`sblas_torch.parallel.comm`), and the mesh says so:
``transport == "gloo-host"``. That is the chosen transport, not a
fallback: an NCCL error raises, and nothing moves a rank to the CPU.

Building a mesh is collective: every rank of the world calls
``make_mesh*`` with the same arguments, in the same order, because each
``dist.new_group`` is. A rank outside a smaller mesh gets one with
``member == False`` and no groups.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.backend import default_device

chips_axis = "chips"
rows_axis = "rows"
cols_axis = "cols"
hosts_axis = "hosts"


def backend_for(device: torch.device) -> tuple[str, str]:
    """``(backend, reason)`` for ranks on ``device``: ``gloo`` on the CPU;
    on a card ``nccl`` where the host's cards are at least its ranks
    (``LOCAL_WORLD_SIZE``, as ``torchrun`` sets it; 1 without it), else
    ``gloo``."""
    if device.type == "cpu":
        return "gloo", "CPU ranks: gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cards = torch.cuda.device_count()
    if cards >= local:
        return "nccl", (f"{local} rank(s) on this host, {cards} card(s): "
                        "a card each, nccl")
    return "gloo", (f"{local} ranks share {cards} card(s): NCCL refuses two "
                    "ranks on one card, so gloo, staged through host memory")


def rank_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda:(LOCAL_RANK % device_count)``;
    raises where torch sees no card."""
    if device is not None:
        return torch.device(device)
    default_device()            # raises without a card
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_world(device: torch.device) -> None:
    """Start the default process group unless one is running: from the
    ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) where it is set, else a world of one rank in this
    process (an in-memory store). The backend is :func:`backend_for`'s."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return
    backend, _ = backend_for(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


@dataclasses.dataclass(eq=False)
class Mesh:
    """World ranks on named axes (``devices``, shaped like the JAX
    package's device array), and this rank's share: its device, its place
    and its process group along each axis."""

    axis_names: tuple
    devices: np.ndarray         # world ranks, shape = the mesh's shape
    rank: int                   # this rank, in the world
    device: torch.device
    backend: str
    backend_reason: str
    transport: str              # "nccl", "gloo" or "gloo-host"
    groups: dict                # axis -> this rank's group along it
    ranks_per_card: int | None  # the host's ranks over its cards; CPU: None

    @property
    def correctness_only(self) -> bool:
        """On the CPU, or ranks sharing a card: times say nothing of a
        deployment."""
        return self.ranks_per_card is None or self.ranks_per_card > 1

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def member(self) -> bool:
        return bool((self.devices == self.rank).any())

    @property
    def index(self) -> int:
        """This rank's place in the mesh's row-major order: the shard it
        owns."""
        return int(np.flatnonzero(self.devices.reshape(-1) == self.rank)[0])

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        where = np.argwhere(self.devices == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def axis_size(self, axis: str) -> int:
        return int(self.devices.shape[self.axis_names.index(axis)])

    def world_group(self):
        """The group of every rank of the mesh (a 1D mesh's axis group)."""
        return self.groups["_all"]


def _mesh(axis_names: tuple, devices: np.ndarray,
          device: torch.device) -> Mesh:
    rank = dist.get_rank()
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the default group runs nccl; a mesh on {device} "
                         "needs gloo")
    want, reason = backend_for(device)
    if want != backend:
        reason = f"the caller's default group ({backend})"
    transport = "gloo-host" if (backend == "gloo"
                                and device.type == "cuda") else backend
    per_card = None
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        per_card = -(-local // torch.cuda.device_count())
    groups = {}
    # every rank creates every group, in one order (dist.new_group is
    # collective over the world); a 1D mesh's axis group is its whole
    lines = {ax: list(np.moveaxis(devices, i, -1).reshape(
        -1, devices.shape[i])) for i, ax in enumerate(axis_names)}
    if len(axis_names) > 1:
        lines["_all"] = [devices.reshape(-1)]
    for ax, ax_lines in lines.items():
        for line in ax_lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[ax] = g
    if len(axis_names) == 1 and axis_names[0] in groups:
        groups["_all"] = groups[axis_names[0]]
    return Mesh(tuple(axis_names), devices, rank, device, backend, reason,
                transport, groups, per_card)


def _world(device) -> tuple[torch.device, int]:
    dev = rank_device(device)
    init_world(dev)
    return dev, dist.get_world_size()


def make_mesh(ndev: int | None = None, *, device=None) -> Mesh:
    """1D ``chips`` mesh over the first ``ndev`` ranks (default: all)."""
    dev, world = _world(device)
    if ndev is None:
        ndev = world
    if ndev > world:
        raise ValueError(f"requested {ndev} devices, have {world}")
    return _mesh((chips_axis,), np.arange(ndev), dev)


def make_mesh2d(rows: int | None = None, cols: int | None = None, *,
                device=None) -> Mesh:
    """2D (``rows``, ``cols``) mesh. With no sizes, the most-square
    factorization of the world size (rows <= cols), as in the JAX
    package."""
    dev, n = _world(device)
    if rows is None and cols is None:
        rows = int(np.sqrt(n))
        while n % rows:
            rows -= 1
        cols = n // rows
    elif rows is None:
        rows = n // cols
    elif cols is None:
        cols = n // rows
    if rows * cols > n:
        raise ValueError(f"requested {rows}x{cols} devices, have {n}")
    return _mesh((rows_axis, cols_axis),
                 np.arange(rows * cols).reshape(rows, cols), dev)


def make_mesh_hier(hosts: int | None = None, chips: int | None = None, *,
                   device=None) -> Mesh:
    """(``hosts``, ``chips``) mesh. With no sizes, ``chips`` is the ranks a
    host (``LOCAL_WORLD_SIZE``) and ``hosts`` the world over that:
    ``torchrun`` numbers a host's ranks contiguously, so ``chips`` stays
    within a host."""
    dev, n = _world(device)
    if hosts is None and chips is None:
        chips = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        hosts = max(n // chips, 1)
    elif hosts is None:
        hosts = n // chips
    elif chips is None:
        chips = n // hosts
    if hosts * chips > n:
        raise ValueError(f"requested {hosts}x{chips} devices, have {n}")
    return _mesh((hosts_axis, chips_axis),
                 np.arange(hosts * chips).reshape(hosts, chips), dev)
