"""Row-sharded tensors on the 2-D `data x space` mesh: the halo exchange
of the convs and pools, and the gather of a row-sharded tensor over the
space group. Their counterpart is no module of the JAX package: GSPMD
emits these collectives by itself when the image height is sharded on the
mesh's `space` axis (`yolo_from_scratch_tpu/parallel/mesh.py:14-21`).

`halo_rows(x, top, bottom, fill, mesh)` gives a rank's NCHW row block the
`top` rows above it and the `bottom` rows below it, as a 3x3 conv (1 and
1, or 1 and 0 at stride 2) or a 5x5 pool (2 and 2) reads them, with
`fill` (0 for a conv's zero padding, -inf for a pool's) in the rows beyond
the global image's edge. A halo may be wider than a rank's block (SPPF's
2 rows at P5 with one P5 row a rank): the rows then come from ranks
further away. Backward, each halo row's gradient goes back to the rank
that owns the row and is added to that rank's gradient there.

The blocks follow the plan of `parallel/mesh.py` (`active_blocks`): they
may differ by a P5 row, and a rank may hold none (a P5 grid smaller than
the space axis). Such a rank still joins every exchange, with nothing in
its slot; its halo rows then come from the ranks before it, and an op on
its tile, too short for the op, runs on a tile padded to the op's size
and keeps none of its output rows (`fit_rows`), so that its graph, and
so its backward's exchanges, are every other rank's.

Both exchanges are one `all_reduce` over the space group of a buffer with
one slot a rank, zero but in this rank's slot: every rank writes its
first and last rows (as many as the widest halo, at most its block; or
its whole block, for the gather) into its slot, and the sum leaves every
rank's rows in every rank's copy (x + 0 is exact, so the rows arrive bit
for bit). `all_reduce` is what
`gloo` runs on CUDA tensors too (`parallel/mesh.py`), so two ranks can
share one card; bf16 rows travel as float32, which holds them exactly,
since not every backend sums bf16. A failed collective raises; nothing
falls back to an unsharded path.
"""

from __future__ import annotations

import bisect

import torch
import torch.distributed as dist
import torch.nn.functional as F

from yolo_from_scratch_tpu_torch.parallel.mesh import Mesh, active_blocks


def _wire(dtype):
    """The dtype a tensor of `dtype` travels in: float32 for 16-bit
    floats, else its own."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _halo_plan(s: int, blocks, top: int, bottom: int):
    """Where each halo row of rank s comes from, the ranks' heights
    `blocks`: (m, above, below), with m the rows a slot's half holds (the
    widest halo, at most the largest block; rank r fills min(m, h_r) of
    them) and `above` / `below` lists of indices into the gathered
    (n * 2m) rows, slot r holding rank r's first rows then its last ones,
    or None for a row beyond the global edge. A row above comes from its
    owner's last rows, a row below from its first, so every halo row has
    one source."""
    m = min(max(top, bottom), max(blocks))
    starts = [sum(blocks[:r]) for r in range(len(blocks))]
    total = sum(blocks)

    def source(g, from_end):
        if g < 0 or g >= total:
            return None
        r = bisect.bisect_right(starts, g) - 1
        i, h = g - starts[r], blocks[r]
        return r * 2 * m + (m + i - (h - min(m, h)) if from_end else i)

    lo, hi = starts[s], starts[s] + blocks[s]
    above = [source(g, True) for g in range(lo - top, lo)]
    below = [source(g, False) for g in range(hi, hi + bottom)]
    return m, above, below


def _rows(buf, plan, fill, like):
    """The halo rows of `plan` from the gathered (n * 2m, B, C, W) rows,
    as (B, C, len(plan), W) in `like`'s dtype, `fill` beyond the edge."""
    if not plan:
        return like[:, :, :0]
    pad = torch.full_like(buf[0], fill)
    rows = [pad if i is None else buf[i] for i in plan]
    return torch.stack(rows, dim=2).to(like.dtype)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, top, bottom, fill):
        b, c, h, w = x.shape
        n, s = mesh.n_space, mesh.space_index
        m, above, below = _halo_plan(s, active_blocks(h, w), top, bottom)
        k = min(m, h)
        buf = x.new_zeros((n, 2 * m, b, c, w), dtype=_wire(x.dtype))
        buf[s, :k] = x[:, :, :k].permute(2, 0, 1, 3)
        buf[s, m:m + k] = x[:, :, h - k:].permute(2, 0, 1, 3)
        dist.all_reduce(buf, group=mesh.space_group)
        buf = buf.reshape(n * 2 * m, b, c, w)
        ctx.mesh, ctx.plan, ctx.shape = mesh, (m, above, below), x.shape
        return torch.cat([_rows(buf, above, fill, x), x,
                          _rows(buf, below, fill, x)], dim=2)

    @staticmethod
    def backward(ctx, dy):
        b, c, h, w = ctx.shape
        mesh = ctx.mesh
        n, s = mesh.n_space, mesh.space_index
        m, above, below = ctx.plan
        top, k = len(above), min(m, h)
        buf = dy.new_zeros((n * 2 * m, b, c, w), dtype=_wire(dy.dtype))
        for j, i in enumerate(above):
            if i is not None:
                buf[i] = dy[:, :, j]
        for j, i in enumerate(below):
            if i is not None:
                buf[i] = dy[:, :, top + h + j]
        buf = buf.reshape(n, 2 * m, b, c, w)
        dist.all_reduce(buf, group=mesh.space_group)
        mine = buf[s].permute(1, 2, 0, 3)  # (B, C, 2m, W)
        dx = dy[:, :, top:top + h].to(buf.dtype)
        dx[:, :, :k] += mine[:, :, :k]
        dx[:, :, h - k:] += mine[:, :, m:m + k]
        return dx.to(dy.dtype), None, None, None, None


def halo_rows(x, top: int, bottom: int, fill: float, mesh: Mesh):
    """NCHW x, this rank's row block on `mesh` (which has a space axis),
    with `top` rows above and `bottom` rows below from the ranks that own
    them, `fill` beyond the global image: (B, C, top + h + bottom, W)."""
    if top == bottom == 0:
        return x
    return _HaloRows.apply(x, mesh, top, bottom, fill)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        n, s = mesh.n_space, mesh.space_index
        blocks = active_blocks(x.shape[1], x.shape[2])
        buf = x.new_zeros((n, x.shape[0], max(blocks), *x.shape[2:]),
                          dtype=_wire(x.dtype))
        buf[s, :, :x.shape[1]] = x
        dist.all_reduce(buf, group=mesh.space_group)
        ctx.rows = sum(blocks[:s]), x.shape[1]
        return torch.cat([buf[r, :, :h] for r, h in enumerate(blocks)],
                         dim=1).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        start, h = ctx.rows
        return dy[:, start:start + h].contiguous(), None


def gather_rows(x, mesh: Mesh):
    """The whole images of this rank's data shard from its row blocks:
    dimension 1 of x (B, h, W, ...) gathered over `mesh`'s space group in
    rank order (the blocks of the active plan, `active_blocks`), (B, H,
    W, ...). Backward keeps this rank's rows of the gradient: the caller
    computes the same function of the gathered tensor on every rank of
    the group, so the gradient of one copy, summed over the ranks' rows,
    is the gradient of the function."""
    return _GatherRows.apply(x, mesh)


def fit_rows(op, x, need: int, fill: float = 0.0):
    """op(x) on an NCHW tile; on a tile of fewer than `need` rows (a rank
    that holds no rows, its halo alone), op on the tile padded below with
    rows of `fill` to `need` rows, none of its output rows kept: an empty
    output joined to x and to op's weights in the graph, whose backward
    gives them zeros."""
    short = need - x.shape[2]
    if short <= 0:
        return op(x)
    return op(F.pad(x, (0, 0, 0, short), value=fill))[:, :, :0]
