"""Spatial sharding over the model axis: the counterpart of the JAX
package's `batch_sharding(spatial=True)` (shmgan_tpu/parallel/mesh.py),
where GSPMD puts H of every activation on the model axis, keeps every
parameter whole and inserts the halo exchanges.

On a (data D x model M) mesh with `mesh.spatial_sharding`, rank (i, j)
holds data block i of the batch and, of every feature map of height h,
rows `span(h, M, j)`: h / M rows a rank (GSPMD's ceil(h / M) where h does
not divide). The train step (train/step.py) runs its models and losses on
those bands through a `Band`, which every layer asks how to run:

  rows     a convolution whose window reaches past its band: the k rows
           above from rank j - 1 and below from rank j + 1 (`_Halo`, one
           all_gather of every rank's edge rows), zeros at the image's own
           edges as the convolution's padding gives them; backward, each
           halo's gradient goes back to the rank that owns those rows and
           is added there in float32;
  whole    the gather-whole rule: a block whose map's height does not
           divide by M, or whose band is thinner than the halo it needs,
           runs on the whole map gathered on every rank of the row
           (`_Gather`: backward, the ranks' gradients summed, then this
           rank's rows), and the rank keeps its band of the result
           (`_Keep`), as GSPMD runs such a map;
  local    a row-local function (a 1x1 convolution, a pool whose window
           the band holds, an elementwise step);
  instance_norm, preprocess   the kernels' band entry points
           (ops/kernels/instance_norm.py, ops/kernels/preprocess.py): the
           band's moments, joined over the row, then the affine;
  reduce, mean   a sum over the whole map: each band's partial sum, added
           over the row in float32 (`_RowSum`; backward, identity: every
           rank holds the same total and uses it alike);
  extreme  a per-image min or max over the row; its gradient goes to the
           elements equal to it, split evenly among them across the row,
           as `jax.grad` of `jnp.min` / `jnp.max` splits it;
  gather_whole, take, flip   a whole map without a gradient (the chroma
           prior's quantiles), a rank's rows of a full-size map, the paired
           up/down flip (rank j's band becomes rank M - 1 - j's reversed).

Every collective runs on the model row's group (`layout.model_group`):
all_gather and all_reduce only, so the path runs over NCCL or over gloo,
with CUDA or CPU tensors.

`Split(m, h)` is the same arithmetic in one process: the maps are whole,
and every op computes each of the m bands as its rank would (the same
kernels at the same shapes, halos cut from the neighbours' rows), joining
the bands' moments and sums in rank order. On a 1 x 2 mesh the mesh and its
split are one computation; a test holds them against each other
(`split_compute`).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.autograd import Function

from shmgan_tpu_torch.parallel.mesh import RankLayout

Fn = Callable[[torch.Tensor], torch.Tensor]


def span(h: int, m: int, j: int) -> Tuple[int, int]:
    """Rows [start, stop) of a map of height h that band j of m holds:
    ceil(h / m) rows a band, as GSPMD cuts an uneven axis; the last bands of
    an uneven cut are shorter, or empty."""
    chunk = -(-h // m)
    start = min(j * chunk, h)
    return start, min(start + chunk, h)


def _dim(t: torch.Tensor, dim: int) -> int:
    return dim % t.dim()


def _zeros(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] = n
    return t.new_zeros(shape)


def _pad_rows(x: torch.Tensor, start: int, stop: int, up: int, down: int,
              dim: int) -> torch.Tensor:
    """Rows [start - up, stop + down) of the whole map x, zeros outside it."""
    h = x.shape[dim]
    lo, hi = max(start - up, 0), min(stop + down, h)
    parts = [_zeros(x, dim, lo - (start - up)), x.narrow(dim, lo, hi - lo),
             _zeros(x, dim, stop + down - hi)]
    return torch.cat([p for p in parts if p.shape[dim]], dim)


def _all_gather(t: torch.Tensor, group, m: int) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(m)]
    dist.all_gather(parts, t, group=group)
    return parts


def _all_reduce_f32(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction over `group` of t, taken in float32, in t's dtype."""
    out = t.float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.dtype)


class _Halo(Function):
    """This rank's band with `up` rows from the rank above and `down` rows
    from the rank below (zeros at the image's edges); backward, each halo's
    gradient added, in float32, to the rows it came from."""

    @staticmethod
    def forward(ctx, x, band, up, down, dim):
        ctx.band, ctx.up, ctx.down, ctx.dim, ctx.hb = band, up, down, dim, x.shape[dim]
        m, j, hb = band.m, band.j, x.shape[dim]
        edges = torch.cat([x.narrow(dim, 0, down), x.narrow(dim, hb - up, up)], dim)
        parts = _all_gather(edges, band.group, m)
        above = parts[j - 1].narrow(dim, down, up) if j > 0 else _zeros(x, dim, up)
        below = parts[j + 1].narrow(dim, 0, down) if j < m - 1 else _zeros(x, dim, down)
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, g):
        band, up, down, dim, hb = ctx.band, ctx.up, ctx.down, ctx.dim, ctx.hb
        m, j = band.m, band.j
        sent = torch.cat([g.narrow(dim, 0, up), g.narrow(dim, up + hb, down)], dim)
        parts = _all_gather(sent, band.group, m)
        below = parts[j + 1].narrow(dim, 0, up) if j < m - 1 else None
        above = parts[j - 1].narrow(dim, up, down) if j > 0 else None
        return _halo_grad(g, below, above, up, down, hb, dim), None, None, None, None


def _halo_grad(g: torch.Tensor, below: Optional[torch.Tensor], above: Optional[torch.Tensor],
               up: int, down: int, hb: int, dim: int) -> torch.Tensor:
    """A band's gradient from the gradient g of its rows with their halos,
    and the gradients of its edge rows that the bands below (its last `up`
    rows) and above (its first `down` rows) took as their halos: added in
    float32, in g's dtype."""
    dx = g.narrow(dim, up, hb).float().clone(memory_format=torch.contiguous_format)
    if below is not None and up:
        dx.narrow(dim, hb - up, up).add_(below.float())
    if above is not None and down:
        dx.narrow(dim, 0, down).add_(above.float())
    return dx.to(g.dtype)


class _SplitHalo(Function):
    """Every band of a whole map with its halos (`_pad_rows`); backward,
    each band's gradient as `_Halo` forms it on its rank, then joined."""

    @staticmethod
    def forward(ctx, x, spans, up, down, dim):
        ctx.spans, ctx.up, ctx.down, ctx.dim = spans, up, down, dim
        return tuple(_pad_rows(x, start, stop, up, down, dim) for start, stop in spans)

    @staticmethod
    def backward(ctx, *gs):
        spans, up, down, dim = ctx.spans, ctx.up, ctx.down, ctx.dim
        m, out = len(spans), []
        for j, ((start, stop), g) in enumerate(zip(spans, gs)):
            below = gs[j + 1].narrow(dim, 0, up) if j < m - 1 else None
            above = gs[j - 1].narrow(dim, up + spans[j - 1][1] - spans[j - 1][0], down) \
                if j > 0 else None
            out.append(_halo_grad(g, below, above, up, down, stop - start, dim))
        return torch.cat(out, dim), None, None, None, None


class _Gather(Function):
    """The whole map from every rank's band; backward, the ranks' gradients
    of the whole map summed (in float32), then this rank's rows."""

    @staticmethod
    def forward(ctx, x, band, dim):
        ctx.band, ctx.dim = band, dim
        chunk = -(-band.h // band.m)
        padded = torch.cat([x, _zeros(x, dim, chunk - x.shape[dim])], dim)
        parts = _all_gather(padded, band.group, band.m)
        rows = [span(band.h, band.m, r) for r in range(band.m)]
        return torch.cat([p.narrow(dim, 0, stop - start)
                          for p, (start, stop) in zip(parts, rows)], dim)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.band.span()
        total = _all_reduce_f32(g, ctx.band.group)
        return total.narrow(ctx.dim, start, stop - start).contiguous(), None, None


class _Keep(Function):
    """This rank's rows of a whole map; backward, zeros elsewhere."""

    @staticmethod
    def forward(ctx, y, band, dim):
        start, stop = band.span()
        ctx.shape, ctx.dim, ctx.rows = y.shape, dim, (start, stop)
        return y.narrow(dim, start, stop - start).contiguous()

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.rows
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, start, stop - start).copy_(g)
        return out, None, None


class _RowSum(Function):
    """The row's partial results added in float32, in their dtype; backward,
    identity (every rank uses the total alike)."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_f32(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Extreme(Function):
    """Per-image min or max of (B, ...) over everything but the batch axis,
    across the row's bands (group None: x is whole); backward, the row's
    gradient of it split evenly among the elements equal to it."""

    @staticmethod
    def forward(ctx, x, largest, group):
        dims = tuple(range(1, x.dim()))
        out = (x.amax if largest else x.amin)(dim=dims, keepdim=True)
        if group is not None:
            out = _all_reduce_f32(out, group,
                                  dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN)
        hit = x == out
        count = hit.float().sum(dim=dims, keepdim=True)
        if group is not None:
            count = _all_reduce_f32(count, group)
        ctx.save_for_backward(hit, count)
        ctx.group, ctx.dtype = group, x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        g = g.float()
        if ctx.group is not None:
            g = _all_reduce_f32(g, ctx.group)
        return (hit * (g / count)).to(ctx.dtype), None, None


class Band:
    """Rank j's rows of a feature map of height h on its model row of m
    ranks, and the layers' ops on them (see the module's docstring)."""

    def __init__(self, layout: RankLayout, h: int):
        self.layout, self.h = layout, h
        self.m, self.j, self.group = layout.model_parallel, layout.model_index, layout.model_group

    def at(self, h: int) -> "Band":
        """The same rank's band of a map of height h."""
        return Band(self.layout, h)

    def span(self) -> Tuple[int, int]:
        return span(self.h, self.m, self.j)

    def fits(self, halo: int = 0, step: int = 1) -> bool:
        """Whether a block runs on bands: h divides into m bands of a
        multiple of `step` rows (a stride or a pool's window), each at least
        `halo` rows (the rows a window takes from a neighbour)."""
        return self.h % (self.m * step) == 0 and self.h // self.m >= max(halo, 1)

    # -- communication, for the kernels' band entry points
    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The row's t, stacked in rank order: (m, *t.shape)."""
        return torch.stack(_all_gather(t, self.group, self.m))

    def sum_f32(self, t: torch.Tensor) -> torch.Tensor:
        """The row's t added in float32, in t's dtype."""
        return _all_reduce_f32(t, self.group)

    # -- layers
    def rows(self, x: torch.Tensor, fn: Fn, up: int = 0, down: int = 0,
             dim: int = 2) -> torch.Tensor:
        """fn of this band with `up` halo rows above it and `down` below."""
        return fn(_Halo.apply(x, self, up, down, _dim(x, dim)) if up or down else x)

    def whole(self, x: torch.Tensor, fn: Fn, h_out: int, dim: int = 2) -> torch.Tensor:
        """This band of fn of the whole map (the gather-whole rule); fn's
        output is a map of height h_out."""
        d = _dim(x, dim)
        return _Keep.apply(fn(_Gather.apply(x, self, d)), self.at(h_out), d)

    def local(self, x: torch.Tensor, fn: Fn, dim: int = 2) -> torch.Tensor:
        return fn(x)

    def instance_norm(self, x: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
        from shmgan_tpu_torch.ops.kernels import instance_norm as ink

        return ink.instance_norm_band(x, gamma, beta, eps, self)

    def preprocess(self, rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        from shmgan_tpu_torch.ops.kernels import preprocess as pre

        return pre.fused_standardize_yuv_band(rgb, self)

    def reduce(self, t: torch.Tensor, fn: Callable[[torch.Tensor, int, int], torch.Tensor],
               dim: int = -3) -> torch.Tensor:
        """fn(band, start, stop) (a partial sum over this band's rows
        [start, stop) of the map) added over the row."""
        start, stop = self.span()
        return _RowSum.apply(fn(t, start, stop), self.group)

    def mean(self, t: torch.Tensor, dim: int = -3) -> torch.Tensor:
        """The mean of every element of the whole map, t's rows on `dim`."""
        d = _dim(t, dim)
        count = math.prod(t.shape[:d] + t.shape[d + 1:]) * self.h
        return self.reduce(t, lambda b, start, stop: b.sum(), d) / count

    def extreme(self, x: torch.Tensor, largest: bool) -> torch.Tensor:
        return _Extreme.apply(x, largest, self.group)

    def gather_whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole map, without a gradient."""
        with torch.no_grad():
            return _Gather.apply(x, self, _dim(x, dim))

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of a whole map (a full-size draw)."""
        start, stop = span(t.shape[dim], self.m, self.j)
        return t.narrow(dim, start, stop - start)

    def flip(self, views: torch.Tensor, flip: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The bands of the views flipped up/down where `flip`: rank M - 1 -
        j's band, reversed."""
        mirrored = self.take(self.gather_whole(views, dim).flip(dim), dim)
        return torch.where(flip, mirrored, views)


class Split:
    """The mesh's arithmetic in one process on whole maps: every op as m
    bands compute it on their ranks, the bands joined in rank order (see the
    module's docstring). A block the gather-whole rule runs whole on the
    mesh runs on the whole map here."""

    def __init__(self, m: int, h: int):
        self.m, self.h = m, h

    def at(self, h: int) -> "Split":
        return Split(self.m, h)

    def spans(self) -> List[Tuple[int, int]]:
        return [span(self.h, self.m, j) for j in range(self.m)]

    fits = Band.fits

    def rows(self, x, fn, up=0, down=0, dim=2):
        d = _dim(x, dim)
        if not (up or down):
            return self.local(x, fn, d)
        return torch.cat([fn(e) for e in _SplitHalo.apply(x, self.spans(), up, down, d)], d)

    def whole(self, x, fn, h_out, dim=2):
        return fn(x)

    def local(self, x, fn, dim=2):
        d = _dim(x, dim)
        return torch.cat([fn(x.narrow(d, start, stop - start).contiguous())
                          for start, stop in self.spans()], d)

    def instance_norm(self, x, gamma, beta, eps):
        from shmgan_tpu_torch.ops.kernels import instance_norm as ink

        return ink.instance_norm_split(x, gamma, beta, eps, self.m)

    def preprocess(self, rgb):
        from shmgan_tpu_torch.ops.kernels import preprocess as pre

        return pre.fused_standardize_yuv_split(rgb, self.m)

    def reduce(self, t, fn, dim=-3):
        d = _dim(t, dim)
        parts = [fn(t.narrow(d, start, stop - start).contiguous(), start, stop)
                 for start, stop in self.spans()]
        out = parts[0].float()
        for p in parts[1:]:
            out = out + p.float()
        return out.to(parts[0].dtype)

    def mean(self, t, dim=-3):
        return self.reduce(t, lambda b, start, stop: b.sum(), dim) / t.numel()

    def extreme(self, x, largest):
        return _Extreme.apply(x, largest, None)

    def gather_whole(self, x, dim):
        return x

    def take(self, t, dim):
        return t

    def flip(self, views, flip, dim=2):
        return torch.where(flip, views.flip(dim), views)


class LocalRow:
    """A model row of one rank, for the band entry points where the band is
    the whole map: the kernels' timings, and tests against the whole-map
    versions."""
    m = 1

    @staticmethod
    def gather(t: torch.Tensor) -> torch.Tensor:
        return t[None]

    @staticmethod
    def sum_f32(t: torch.Tensor) -> torch.Tensor:
        return t


_split: Optional[int] = None


@contextmanager
def split_compute(m: int):
    """Inside the block, a train step on one rank (no layout) runs as the
    mesh's m bands in one process (`Split`)."""
    global _split
    before, _split = _split, m
    try:
        yield
    finally:
        _split = before


def step_band(layout: Optional[RankLayout], rows: int):
    """The Band of a train step whose images' bands are `rows` high under
    `layout` (None unless it is spatial over more than one rank), or the
    Split of `split_compute` (rows: the whole images' height)."""
    if layout is not None and layout.spatial and layout.model_parallel > 1:
        return Band(layout, rows * layout.model_parallel)
    if _split is not None:
        return Split(_split, rows)
    return None
