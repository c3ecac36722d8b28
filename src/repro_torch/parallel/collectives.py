"""Differentiable collectives over rank lists (a port-only helper: the
reference's counterpart is GSPMD, which inserts these collectives and
their transposes itself).

Each function takes a mesh of ranks (``launch/mesh.py``), a list of
per-rank tensors and the axes it runs over, and returns a list.  The
forward is a ``core/transport.py`` collective; the backward is its
conjugate, so its bytes are counted under ``transport.bytes_moved`` by the
same conventions:

* ``psum``          — sum over the group; backward the identity (Megatron's
  *g*: after a row-parallel product, whose consumers are replicated);
* ``copy``          — the identity; backward a psum (Megatron's *f*: before
  a column-parallel product, or a replicated weight consumed in parts);
* ``all_gather``    — tiled gather along ``dim``; backward a psum-scatter
  (``grad="sum"``: the consumers hold different parts, as data ranks with
  their rows do), or each rank's own chunk of its gradient
  (``grad="slice"``: replicated consumers, whose gradients are equal);
* ``psum_scatter``  — tiled sum-scatter along ``dim``; backward an
  all-gather;
* ``split``         — each rank's chunk along ``dim``; backward an
  all-gather (a replicated value entering a sequence-split region);
* ``all_to_all``    — backward the reverse all-to-all;
* ``deal``          — the group's chunks dealt round it (``transport.deal``:
  mamba's x / z halves to each rank's channels); backward the deal back.

The convention is Megatron's: a value replicated over an axis carries the
whole gradient on every rank, so every rank's loss is seeded with one.
Over an axis of size 1 each function is the identity and moves nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core import transport as TR


def _n(mesh, axes) -> int:
    return len(mesh.groups(axes)[0])


def _unshared(xs: list) -> tuple:
    """Outputs of one autograd node must be distinct tensors: a tensor
    that several ranks of one device share is cloned for all but one (the
    collective's delivery, ``transport.collective_scope``)."""
    seen, out = set(), []
    with TR.collective_scope():
        for x in xs:
            out.append(x.clone() if id(x) in seen else x)
            seen.add(id(x))
    return tuple(out)


def _own_chunks(mesh, xs, axes, dim) -> list:
    """Each rank's chunk of its own tensor along ``dim``, by its position
    in its group."""
    out = [None] * mesh.size
    for g in mesh.groups(axes):
        for j, r in enumerate(g):
            out[r] = xs[r].chunk(len(g), dim=dim)[j]
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        return _unshared(TR.psum(mesh, list(xs), axes))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *gs)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_unshared(TR.psum(ctx.mesh, list(gs),
                                               ctx.axes)))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, grad, *xs):
        ctx.mesh, ctx.axes, ctx.dim, ctx.grad = mesh, axes, dim, grad
        return _unshared(TR.all_gather(mesh, list(xs), axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        if ctx.grad == "sum":
            out = TR.psum_scatter(ctx.mesh, list(gs), ctx.axes, ctx.dim)
        else:
            out = [g.contiguous() for g in _own_chunks(ctx.mesh, gs,
                                                       ctx.axes, ctx.dim)]
        return (None, None, None, None, *out)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return tuple(TR.psum_scatter(mesh, list(xs), axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_unshared(TR.all_gather(
            ctx.mesh, [g.contiguous() for g in gs], ctx.axes, ctx.dim)))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return tuple(c.contiguous() for c in _own_chunks(mesh, xs, axes,
                                                           dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_unshared(TR.all_gather(
            ctx.mesh, [g.contiguous() for g in gs], ctx.axes, ctx.dim)))


class _Deal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, parts, *xs):
        ctx.mesh, ctx.axes, ctx.dim, ctx.parts = mesh, axes, dim, parts
        return tuple(TR.deal(mesh, list(xs), axes, dim, parts))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, None, *TR.deal(
            ctx.mesh, [g.contiguous() for g in gs], ctx.axes, ctx.dim,
            ctx.parts, inverse=True))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, split_dim, concat_dim, *xs):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.dims = (split_dim, concat_dim)
        return tuple(TR.all_to_all(mesh, list(xs), axes, split_dim,
                                   concat_dim))

    @staticmethod
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        return (None, None, None, None, *TR.all_to_all(
            ctx.mesh, [g.contiguous() for g in gs], ctx.axes, concat_dim,
            split_dim))


def psum(mesh, xs, axes) -> list:
    if _n(mesh, axes) == 1:
        return list(xs)
    return list(_Psum.apply(mesh, axes, *xs))


def copy(mesh, xs, axes) -> list:
    if _n(mesh, axes) == 1:
        return list(xs)
    return list(_Copy.apply(mesh, axes, *xs))


def all_gather(mesh, xs, axes, dim: int = 0, grad: str = "sum") -> list:
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad {grad!r}: sum or slice")
    if _n(mesh, axes) == 1:
        return list(xs)
    return list(_AllGather.apply(mesh, axes, dim, grad, *xs))


def psum_scatter(mesh, xs, axes, dim: int = 0) -> list:
    if _n(mesh, axes) == 1:
        return list(xs)
    return list(_PsumScatter.apply(mesh, axes, dim, *xs))


def split(mesh, xs, axes, dim: int = 0) -> list:
    if _n(mesh, axes) == 1:
        return list(xs)
    return list(_Split.apply(mesh, axes, dim, *xs))


def all_to_all(mesh, xs, axes, split_dim: int, concat_dim: int) -> list:
    if _n(mesh, axes) == 1:
        return list(xs)
    return list(_AllToAll.apply(mesh, axes, split_dim, concat_dim, *xs))


def deal(mesh, xs, axes, dim: int, parts: int) -> list:
    if _n(mesh, axes) == 1:
        return list(xs)
    return list(_Deal.apply(mesh, axes, dim, parts, *xs))


@torch.no_grad()
def pmax(mesh, xs, axes) -> list:
    """The group's elementwise maximum (no gradient: the CE's shift)."""
    if _n(mesh, axes) == 1:
        return list(xs)
    return TR.pmax(mesh, list(xs), axes)
