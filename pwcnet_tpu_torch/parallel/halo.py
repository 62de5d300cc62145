"""Ring halo exchange and the spatially sharded warp + correlation
(counterpart of ``pwcnet_tpu/parallel/halo.py``).

Activations are sharded along image H over the ranks of a
:class:`~pwcnet_tpu_torch.parallel.mesh.GridMesh`'s spatial axis: rank ``r`` holds rows ``[r*t, (r+1)*t)``. ``exchange_rows`` gives
each shard rows of its ring neighbours (``dist.batch_isend_irecv``, several
hops when a shard has fewer rows than asked for), with zeros past the
global edges. It is differentiable: its backward is the transpose of the
exchange, as JAX's ``ppermute`` transposes to the reverse ring. The
gradient of the rows a rank received goes back to the rank that sent them
and is added onto the rows it sent; gradient on the zeros past a global
edge is dropped. So the sharded warp + correlation, and every op built on
the exchange, has the unsharded gradients (the global loss being the sum of
the ranks' local losses).

Semantics contract, as in the JAX package: the warp's vertical reach across
a shard edge is bounded by the exchanged halo. A sample beyond the
exchanged rows reads the 1-pixel zero ring and the farthest exchanged row
(the halo-bound clamp of ``ops/warp.py:warp_ext_corners_ref``); flows
within the bound give exactly the unsharded result, with the in-bounds and
coverage masks tested in global image rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from pwcnet_tpu_torch.ops.cost_volume import (cost_volume_prepadded,
                                              cost_volume_prepadded_ref)
from pwcnet_tpu_torch.ops.warp import warp_ext_ref
from pwcnet_tpu_torch.ops.warp_corr import (fused_is_profitable,
                                            warp_corr_prepadded)
from pwcnet_tpu_torch.parallel.mesh import GridMesh


def to_comm(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """A contiguous copy of ``x`` that the mesh's backend can send (on the
    host under ``gloo`` for a CUDA tensor). Not differentiable: the
    collectives' autograd Functions call it on their own inputs."""
    return x.cpu().contiguous() if mesh.stage_on_host else x.contiguous()


def _hop(down: torch.Tensor, up: torch.Tensor, mesh: GridMesh):
    """One ring step: ``down`` goes to rank + 1 and ``up`` to rank - 1.
    Returns (from the rank above, from the rank below), zeros where there is
    no neighbour."""
    r, s = mesh.rank, mesh.size
    from_above, from_below = torch.zeros_like(down), torch.zeros_like(up)
    if s == 1:
        return from_above, from_below
    ops = []
    if r > 0:
        peer = mesh.global_rank(r - 1)
        ops += [dist.P2POp(dist.isend, up, peer, mesh.group),
                dist.P2POp(dist.irecv, from_above, peer, mesh.group)]
    if r < s - 1:
        peer = mesh.global_rank(r + 1)
        ops += [dist.P2POp(dist.isend, down, peer, mesh.group),
                dist.P2POp(dist.irecv, from_below, peer, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_above, from_below


class _ExchangeRows(torch.autograd.Function):
    """``exchange_rows`` with its transpose as the backward."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh, dim):
        t = x.shape[dim]
        hops = max(-(-top // t), -(-bottom // t))
        ctx.geometry = (top, bottom, mesh, dim, hops)
        down = up = to_comm(x, mesh)
        above, below = [], []
        for _ in range(hops):
            down, up = _hop(down, up, mesh)
            above.insert(0, down)  # from the ranks r - hops .. r - 1
            below.append(up)       # from the ranks r + 1 .. r + hops
        top_rows = torch.cat(above, dim).narrow(dim, hops * t - top, top)
        bot_rows = torch.cat(below, dim).narrow(dim, 0, bottom)
        return torch.cat([top_rows.to(x.device, x.dtype), x,
                          bot_rows.to(x.device, x.dtype)], dim)

    @staticmethod
    def backward(ctx, g):
        top, bottom, mesh, dim, hops = ctx.geometry
        t = g.shape[dim] - top - bottom
        g_top, g_mid, g_bot = g.split([top, t, bottom], dim)
        # The gradient of the block received from rank r - k (k = 1..hops)
        # and of the block from rank r + k, zero rows where a count is not
        # a multiple of t.
        g_top = torch.cat([g_top.new_zeros(_rows(g, dim, hops * t - top)),
                           g_top], dim)
        g_bot = torch.cat([g_bot, g_bot.new_zeros(
            _rows(g, dim, hops * t - bottom))], dim)
        # g_above[k]: the gradient of the block from rank r - k - 1, which
        # this rank forwarded down k more hops; g_below[k] likewise.
        g_above = [to_comm(c, mesh) for c in g_top.split(t, dim)[::-1]]
        g_below = [to_comm(c, mesh) for c in g_bot.split(t, dim)]
        # Reverse hop order: the gradient of what a rank received at hop
        # k + 1 goes back to the rank that sent it, where it joins the
        # gradient of the block that rank received at hop k (or of its own
        # rows at k = 0). What goes past a global edge is dropped (``_hop``
        # sends nothing there).
        down, up = g_above[-1], g_below[-1]
        for k in range(hops - 1, -1, -1):
            from_above, from_below = _hop(up, down, mesh)
            if k:
                down = from_below + g_above[k - 1]
                up = from_above + g_below[k - 1]
        gx = g_mid + (from_below + from_above).to(g.device, g.dtype)
        return gx, None, None, None, None


def _rows(x: torch.Tensor, dim: int, n: int):
    """The shape of ``x`` with ``n`` rows along ``dim``."""
    shape = list(x.shape)
    shape[dim] = n
    return shape


def exchange_rows(x: torch.Tensor, top: int, bottom: int, mesh: GridMesh,
                  dim: int = 1) -> torch.Tensor:
    """Extend the shard ``x`` along ``dim`` with ``top`` rows of the shards
    above and ``bottom`` rows of the shards below (zeros past the global
    edges). Multi-hop when a count exceeds the shard height: each hop
    forwards whole blocks one more rank away, as the JAX ``ppermute`` ring
    does. Every rank must call it with the same counts.

    Differentiable: the backward sends the gradient of the received rows
    back up and down the ring to the ranks that own them, in reverse hop
    order, and adds it onto the rows they sent. The backward is a
    point-to-point exchange too, so every rank must take part in it: where
    one rank's output enters the loss, every rank's must (with a zero
    gradient where its rows do not matter), or the ranks wait on each
    other."""
    if top == 0 and bottom == 0:
        return x
    return _ExchangeRows.apply(x, top, bottom, mesh, dim)


def exchange_halo(x: torch.Tensor, halo: int, mesh: GridMesh
                  ) -> torch.Tensor:
    """(N, t, W, C) shard -> (N, t + 2*halo, W, C): ``halo`` rows from each
    ring neighbour, zeros at the global edges (JAX ``exchange_halo``)."""
    return exchange_rows(x, halo, halo, mesh)


def corr_halo(t: int, halo_rows: int, d: int) -> int:
    """Rows of f2 exchanged at a level of shard height ``t``: the JAX
    island's ``max(min(halo_rows, t), d)``."""
    return max(min(halo_rows, t), d)


def warp_corr_spatial_local(f1: torch.Tensor, f2e: torch.Tensor,
                            flow_e: Optional[torch.Tensor], *, row0: int,
                            h_global: int, halo: int,
                            max_displacement: int = 4,
                            backend: str = "pallas",
                            fused_min_pixels: Optional[int] = None
                            ) -> torch.Tensor:
    """The shard-local step of the sharded warp + correlation, given the
    exchanged rows: ``f2e`` (N, t + 2*halo, W, C) holds global rows
    ``[row0 - halo, row0 + t + halo)``, ``flow_e`` (N, t + 2d, W, 2) the
    pixel flow at rows ``[row0 - d, row0 + t + d)`` (None at the coarsest
    level: no warp). Returns (N, t, W, (2d+1)^2).

    Dispatch as the JAX island: no warp -> the halo-row correlation K1p;
    ``"fused"`` at a level whose shard-local t x W reaches the fused
    threshold -> K6p; otherwise ``warp_ext_ref`` + K1p. ``"lax"`` runs the
    plain versions (``warp_ext_ref``, ``cost_volume_prepadded_ref``) on
    any device."""
    if backend not in ("lax", "pallas", "fused"):
        raise ValueError(f"unknown corr_backend {backend!r}")
    d = max_displacement
    t, w = f1.shape[1], f1.shape[2]
    if (flow_e is not None and backend == "fused"
            and fused_is_profitable(t, w, fused_min_pixels)):
        return warp_corr_prepadded(f1, f2e, flow_e, row0=row0,
                                   h_global=h_global, halo=halo,
                                   max_displacement=d)
    if flow_e is None:
        w2e = f2e[:, halo - d:halo + t + d].contiguous()
    else:
        w2e = warp_ext_ref(f2e, flow_e, row0, h_global, halo, d)
    if backend == "lax":
        return cost_volume_prepadded_ref(f1, w2e, d)
    return cost_volume_prepadded(f1, w2e, max_displacement=d)


def warp_corr_spatial(f1: torch.Tensor, f2: torch.Tensor,
                      flow: Optional[torch.Tensor], mesh: GridMesh, *,
                      max_displacement: int = 4, halo_rows: int = 16,
                      backend: str = "pallas",
                      fused_min_pixels: Optional[int] = None
                      ) -> torch.Tensor:
    """Spatially sharded warp + correlation on this rank's shards f1, f2
    (N, t, W, C) and pixel flow (N, t, W, 2) or None: exchange the halo
    rows, then :func:`warp_corr_spatial_local`."""
    d = max_displacement
    t = f1.shape[1]
    halo = corr_halo(t, halo_rows, d)
    f2e = exchange_halo(f2, halo, mesh)
    flow_e = None if flow is None else exchange_halo(flow, d, mesh)
    return warp_corr_spatial_local(
        f1, f2e, flow_e, row0=mesh.rank * t, h_global=mesh.size * t,
        halo=halo, max_displacement=d, backend=backend,
        fused_min_pixels=fused_min_pixels)
