"""The collectives of the distributed plans, over a :class:`Mesh` axis.

Each is the ``torch.distributed`` call for the ``lax`` collective that the
JAX package's ``shard_map`` bodies make:

=====================================  ====================================
``lax.all_gather(..., tiled=True)``    :func:`all_gather`:
                                       ``dist.all_gather_into_tensor`` over
                                       the axis group, equal chunks along
                                       dim 0
``lax.psum``                           :func:`all_reduce`: ``dist.all_reduce``
                                       (``SUM``; ``MAX`` for the halo
                                       plan's width)
``lax.ppermute`` (a ring shift)        :func:`ppermute`:
                                       ``dist.batch_isend_irecv`` of one
                                       send and one receive; several in
                                       one batch: :func:`ppermutes`
=====================================  ====================================

(The JAX package's bodies use no ``psum_scatter``; the port has none.)

On the mesh's ``nccl`` and ``gloo`` transports the tensors go to the call
as they are. On ``gloo-host`` (ranks that share a card, under ``gloo``)
each call copies its tensors to host memory, runs there, and copies the
result back to the card: gloo's CUDA coverage is partial (no send and
receive, no gather into one tensor), and one rule for every call keeps the
transport one thing. At an axis of one rank ``all_gather`` and
``all_reduce`` still call the backend (a world of one runs the real
transport); ``ppermute`` returns its tensor, as the identity permutation
of ``lax.ppermute`` does, with no send to itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

# torch 2.13 renames all_gather_into_tensor (and warns on the old name);
# earlier versions have only the old one
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.transport == "gloo-host" else t


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The axis's chunks ``t`` (one a rank, equal shapes), concatenated in
    axis order along dim 0, on every rank of the axis."""
    t = _host(mesh, t.contiguous())
    out = t.new_empty((mesh.axis_size(axis) * t.shape[0], *t.shape[1:]))
    _all_gather_into(out, t, group=mesh.groups[axis])
    return out.to(mesh.device)


def all_reduce(mesh: Mesh, axis: str, t: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) over the axis's ranks of ``t``, on every rank of
    the axis (a new tensor; ``t`` may be overwritten)."""
    h = _host(mesh, t.contiguous())
    dist.all_reduce(h, op=op, group=mesh.groups[axis])
    return h.to(mesh.device)


def ppermute(mesh: Mesh, axis: str, t: torch.Tensor,
             shift: int) -> torch.Tensor:
    """Ring shift along ``axis``: each rank sends ``t`` to the rank
    ``shift`` places after it (mod the axis size) and returns what the rank
    ``shift`` places before it sent (``lax.ppermute`` with the pairs
    ``(i, i + shift)``)."""
    return ppermutes(mesh, axis, [(t, shift)])[0]


def ppermutes(mesh: Mesh, axis: str, sends: list) -> list:
    """Several ring shifts along ``axis`` in one batch of sends and
    receives (one NCCL group): for each ``(t, shift)`` of ``sends``, in
    order, what :func:`ppermute` returns. Two shifts to one rank arrive in
    the order sent."""
    size = mesh.axis_size(axis)
    if size == 1:
        return [t for t, _ in sends]
    group = mesh.groups[axis]
    me = mesh.coord(axis)
    ranks = dist.get_process_group_ranks(group)
    ops, recvs = [], []
    for t, shift in sends:
        send = _host(mesh, t.contiguous())
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, ranks[(me + shift) % size],
                           group=group),
                dist.P2POp(dist.irecv, recv, ranks[(me - shift) % size],
                           group=group)]
        recvs.append(recv)
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [r.to(mesh.device) for r in recvs]
