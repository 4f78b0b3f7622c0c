"""A whole-image forward split by rows over torch.distributed ranks: what
JAX's `--spatial_shard` mesh does for a torch process.

Counterpart of the `sp` axis of textualdegremoval_tpu/cli/evaluate.py
(:176-190, :218-244): there lq is sharded on H over N devices, the
weights and the reference are replicated, and GSPMD inserts the halo
exchanges of the convolutions and the reductions of the attention
statistics.  Here each rank is one process that holds one slab of rows,
and the network asks for each exchange and reduction itself (the layout
is passed down as an argument, `model(lq_slab, ref, shard=...)`; the
networks that take it are RestormerRefFusion, NAFNetRefFusion and
PromptIRRefFusion on their whole-block routes, DRSformerRefFusion and
SFNetRefFusion):

* `RowShard` is the layout: the padded image's height, every rank's own
  rows in whole units (the network's padding multiple, so that its 2x
  downsamplings and MASA's block grid fall on slab boundaries), and each
  rank's neighbours.  Shares may be uneven; the first ranks take the
  extra units.  A rank with no units still computes on one unit of zeros
  (its `local` rows), whose results nobody reads, so that it makes every
  collective the others make;
* `exchange_rows(x, r, shard)`: x with r rows of each neighbour above and
  below, zero rows at the image's true top and bottom (the zero padding
  the unsharded convolutions see); `halo_rows` keeps only what the
  neighbours sent, for stencils that pad a tensor of their own (a
  TransformerBlock's 2 rows, a NAFBlock's 1);
* `reflect_rows(x, r, shard)`: the same, reflected within the rank's own
  rows at the image's true top and bottom (F.pad's "reflect": SFNet's
  dynamic filters); `check_halo` refuses a halo wider than one unit at
  its level, the most one neighbour is sure to hold;
* `reduce_stats(*tensors, shard=...)`: an in-place float32 sum over the
  ranks: a TransformerBlock's gram and square sums before its softmax, a
  NAFBlock's SCA pixel sums and a PromptGenBlock's feature sums before
  each is divided by the whole image's pixel count, a TKSA gram before
  its top-k masks, the pooled means of MEFC and SFNet's dynamic filters
  and SFNet's InstanceNorm moments (in float64); each sums the rank's own
  rows (`RowShard.own`), never its halo or a rank's unit of zeros;
* `box_mean_rows(x, kernel_size, shard)`: ops/tlc.py's `local_avg_pool`
  of the whole image at the slab's rows: each rank's partial box sums of
  every output row of the valid window, summed over the ranks
  (`box_partial`, `box_finish` for several regions in one reduction:
  SFNet's PatchAP pools each quadrant of the image on its own);
* `gather_rows(x, shard)`: rank 0 gets the whole image.

Every collective runs on the default process group in the same order on
every rank.  Over gloo a CUDA tensor goes through the host; over nccl it
stays on the card.  A shard may carry a `CollectiveTrace`, which counts
each collective with its bytes and host seconds (on CUDA each is timed
between two synchronizations, so a trace slows the forward it reads).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass
class CollectiveTrace:
    """Collectives of one rank: counts, bytes this rank received (an
    exchange: its neighbours' edge rows as gathered; a reduction: the
    buffer's bytes; a gather: the rows rank 0 collects) and host
    seconds."""
    exchanges: int = 0
    exchange_bytes: int = 0
    exchange_s: float = 0.0
    reduces: int = 0
    reduce_bytes: int = 0
    reduce_s: float = 0.0
    gathers: int = 0
    gather_bytes: int = 0
    gather_s: float = 0.0

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        setattr(self, kind + "s", getattr(self, kind + "s") + 1)
        setattr(self, kind + "_bytes", getattr(self, kind + "_bytes") + nbytes)
        setattr(self, kind + "_s", getattr(self, kind + "_s") + seconds)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The row layout of one rank at one resolution.

    height: rows of the padded image at this resolution; rows_of: each
    rank's own rows (consecutive, rank 0 at the top; the world is its
    length); rank: this rank; unit: the rows of one unit at this
    resolution (what a rank without a share computes on); trace: a
    CollectiveTrace or None."""
    height: int
    rows_of: tuple
    rank: int
    unit: int
    trace: CollectiveTrace | None = None

    @classmethod
    def split(cls, height: int, unit: int, rank: int, world: int,
              trace: CollectiveTrace | None = None):
        """The layout of an image of `height` rows padded to a multiple of
        `unit`, its units shared as evenly as the ranks allow (the first
        height // unit % world ranks take one more)."""
        if unit <= 0 or world <= 0 or not 0 <= rank < world:
            raise ValueError(f"RowShard.split: unit {unit}, rank {rank}, "
                             f"world {world}")
        units = -(-height // unit)
        base, extra = divmod(units, world)
        rows_of = tuple((base + (i < extra)) * unit for i in range(world))
        return cls(units * unit, rows_of, rank, unit, trace)

    @property
    def world(self) -> int:
        return len(self.rows_of)

    @property
    def start(self) -> int:
        """The first own row."""
        return sum(self.rows_of[: self.rank])

    @property
    def rows(self) -> int:
        """Own rows; 0 on a rank without a share."""
        return self.rows_of[self.rank]

    @property
    def local(self) -> int:
        """Rows this rank computes on: its own, or one unit of zeros."""
        return self.rows or self.unit

    @property
    def up(self) -> int | None:
        """The rank holding the rows just above, None at the image's top."""
        return self.rank - 1 if self.rows and self.rank > 0 else None

    @property
    def down(self) -> int | None:
        """The rank holding the rows just below, None at the bottom."""
        nxt = self.rank + 1
        if self.rows and nxt < self.world and self.rows_of[nxt]:
            return nxt
        return None

    def scaled(self, factor: int) -> "RowShard":
        """The same layout at 1 / factor of the resolution."""
        if self.unit % factor:
            raise ValueError(f"RowShard: a unit of {self.unit} rows does not "
                             f"scale by 1/{factor}")
        return dataclasses.replace(
            self, height=self.height // factor,
            rows_of=tuple(r // factor for r in self.rows_of),
            unit=self.unit // factor)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of a slab whose sums count: this rank's own (none on a
        rank without a share, whose unit of zeros its convolutions' biases
        make non-zero)."""
        return x[:, : self.rows]

    def slab(self, img: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (B, H, W, C) image zero-padded at the
        bottom to `height` rows (one unit of zeros without a share)."""
        if img.shape[1] > self.height:
            raise ValueError(f"RowShard: an image of {img.shape[1]} rows in "
                             f"a layout of {self.height}")
        if not self.rows:
            return img.new_zeros((img.shape[0], self.unit, *img.shape[2:]))
        img = F.pad(img, (0, 0, 0, 0, 0, self.height - img.shape[1]))
        return img[:, self.start: self.start + self.rows]


def _stage(t: torch.Tensor) -> torch.Tensor:
    """t as the backend takes it: through the host over gloo."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.cpu()
    return t


@contextlib.contextmanager
def _timed(shard: RowShard, kind: str, nbytes: int, device: torch.device):
    """Adds the collective inside to the shard's trace, where it has one."""
    if shard.trace is None:
        yield
        return
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize()
    shard.trace.add(kind, nbytes, time.perf_counter() - t0)


def exchange_rows(x: torch.Tensor, r: int, shard: RowShard) -> torch.Tensor:
    """x (B, local, W, C) with r rows of the neighbour above on top and r
    rows of the neighbour below underneath: (B, local + 2 r, W, C).  At the
    image's true top and bottom the rows are zeros.  One all-gather of
    every rank's first and last r rows (a rank without a share sends its
    zeros, which nobody reads)."""
    b, h, w, c = x.shape
    if not 0 < r <= h:
        raise ValueError(f"exchange_rows: {r} rows of a slab of {h}")
    zeros = x.new_zeros((b, r, w, c))
    if shard.world == 1:
        return torch.cat([zeros, x, zeros], dim=1)
    edges = torch.cat([x[:, :r], x[:, h - r:]], dim=1)
    staged = _stage(edges).contiguous()
    parts = [torch.empty_like(staged) for _ in range(shard.world)]
    with _timed(shard, "exchange", staged.numel() * staged.element_size()
                * (shard.world - 1), x.device):
        dist.all_gather(parts, staged)
    top = zeros if shard.up is None else parts[shard.up][:, r:].to(x.device)
    bottom = (zeros if shard.down is None
              else parts[shard.down][:, :r].to(x.device))
    return torch.cat([top, x, bottom], dim=1)


def halo_rows(x: torch.Tensor, r: int, shard: RowShard):
    """(ext, top): x with r rows of each neighbour and none past the
    image's true top or bottom, x's rows at ext[:, top: top + local].  For
    a stencil that zero-pads a tensor it computes from x (the block's q |
    k | v and GDFN hidden), where zero rows of x would not be that
    padding."""
    ext = exchange_rows(x, r, shard)
    top = r if shard.up is not None else 0
    bottom = r if shard.down is not None else 0
    return ext[:, r - top: ext.shape[1] - r + bottom], top


def check_halo(r: int, shard: RowShard, where: str) -> None:
    """Refuses a halo of r rows at a level whose units are shorter: a
    neighbour holds whole units, so only r <= unit rows are sure to be
    one neighbour's."""
    if r > shard.unit:
        raise ValueError(f"{where}: a halo of {r} rows exceeds the "
                         f"{shard.unit}-row unit of a level of "
                         f"{shard.height} rows")


def reflect_rows(x: torch.Tensor, r: int, shard: RowShard) -> torch.Tensor:
    """x (B, local, W, C) with r rows of each neighbour above and below,
    and at the image's true top and bottom (the padded image's first and
    last row) r rows reflected within x's own rows, as F.pad(mode=
    "reflect") pads the whole image: (B, local + 2 r, W, C)."""
    ext, top = halo_rows(x, r, shard)
    n = shard.local
    if n <= r:
        raise ValueError(f"reflect_rows: {r} rows reflected in a slab of {n}")
    if shard.up is None:
        ext = torch.cat([x[:, 1: r + 1].flip(1), ext], dim=1)
    if shard.down is None:
        ext = torch.cat([ext, x[:, n - 1 - r: n - 1].flip(1)], dim=1)
    return ext


def box_kernel(kernel_size, height: int, width: int) -> tuple[int, int]:
    """`local_avg_pool`'s kernel on an image of height x width: each side
    at most the image's."""
    return min(height, int(kernel_size[0])), min(width, int(kernel_size[1]))


def box_partial(x: torch.Tensor, kernel, height: int, first: int,
                own: int) -> torch.Tensor:
    """This rank's share of the box sums of an image of `height` rows and
    x's width, of which x (B, n, W, C) holds rows first, first + 1, ...
    and the first `own` of them are this rank's: for every output row o
    of the valid window, the float32 sum over its own rows in [o, o + k1)
    of their box sums over W.  (B, height - k1 + 1, W - k2 + 1, C); where
    the kernel covers the image, the sums of its own rows (B, 1, 1, C)."""
    k1, k2 = kernel
    w = x.shape[2]
    xo = x[:, :own].float()
    if k1 >= height and k2 >= w:
        return xo.sum(dim=(1, 2), keepdim=True)
    cw = F.pad(xo.cumsum(2), (0, 0, 1, 0))
    pre = F.pad((cw[:, :, k2:] - cw[:, :, : w + 1 - k2]).cumsum(1),
                (0, 0, 0, 0, 1, 0))
    o = torch.arange(height - k1 + 1, device=x.device)
    lo = (o - first).clamp(0, own)
    hi = (o + k1 - first).clamp(0, own)
    return pre[:, hi] - pre[:, lo]


def box_finish(sums: torch.Tensor, kernel, height: int, width: int,
               first: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The box means of the image's rows first .. first + n - 1 from the
    box sums summed over the ranks (`box_partial`), replicate-padded back
    to the image's size about the centre as `local_avg_pool`'s auto_pad:
    (B, n, W, C), or the image's mean (B, 1, 1, C) where the kernel
    covers it."""
    k1, k2 = kernel
    if k1 >= height and k2 >= width:
        return (sums / float(height * width)).to(dtype)
    out = sums / float(k1 * k2)
    oh, ow = out.shape[1], out.shape[2]
    rows = (torch.arange(first, first + n, device=sums.device)
            - (height - oh) // 2).clamp(0, oh - 1)
    cols = (torch.arange(width, device=sums.device)
            - (width - ow) // 2).clamp(0, ow - 1)
    return out[:, rows][:, :, cols].to(dtype)


def box_mean_rows(x: torch.Tensor, kernel_size,
                  shard: RowShard) -> torch.Tensor:
    """ops/tlc.py `local_avg_pool(image, kernel_size)` at the slab's rows:
    x (B, local, W, C) one rank's slab of an image of shard.height rows.
    One reduction of every rank's partial sums (the valid window's rows,
    a few where the kernel is most of the image).  Returns (B, local, W,
    C), or the image's mean (B, 1, 1, C) where the kernel covers the
    image, as `local_avg_pool`."""
    height = shard.height
    kernel = box_kernel(kernel_size, height, x.shape[2])
    sums, = reduce_stats(box_partial(x, kernel, height, shard.start,
                                     shard.rows), shard=shard)
    return box_finish(sums, kernel, height, x.shape[2], shard.start,
                      x.shape[1], x.dtype)


def image_mean(x: torch.Tensor, shard: RowShard | None = None):
    """x's mean over H and W, (B, 1, 1, C); on a slab of a row-sharded
    image (shard), the float32 sums of its own rows summed over the ranks,
    over the whole image's pixels."""
    if shard is None:
        return x.mean(dim=(1, 2), keepdim=True)
    sums = shard.own(x).float().sum(dim=(1, 2), keepdim=True)
    reduce_stats(sums, shard=shard)
    return (sums / float(shard.height * x.shape[2])).to(x.dtype)


def reduce_stats(*tensors: torch.Tensor, shard: RowShard):
    """Sum each float32 tensor over the ranks, in place (one all-reduce of
    their concatenation); float64 tensors, all of them, where a sum feeds
    a cancellation (SFNet's InstanceNorm moments).  Returns the
    tensors."""
    if shard.world == 1:
        return tensors
    dtype = tensors[0].dtype
    for t in tensors:
        if t.dtype != dtype or dtype not in (torch.float32, torch.float64):
            raise ValueError(f"reduce_stats: {t.dtype} statistics")
    flat = _stage(torch.cat([t.reshape(-1) for t in tensors]))
    with _timed(shard, "reduce", flat.numel() * flat.element_size(),
                tensors[0].device):
        dist.all_reduce(flat)
    flat = flat.to(tensors[0].device)
    off = 0
    for t in tensors:
        t.copy_(flat[off: off + t.numel()].view(t.shape))
        off += t.numel()
    return tensors


def gather_rows(x: torch.Tensor, shard: RowShard):
    """Rank 0: the whole (B, height, W, C) image from every rank's own
    rows of x (B, local, W, C); the other ranks: None.  One gather of the
    slabs padded to the largest."""
    if shard.world == 1:
        return x[:, : shard.rows]
    most = max(max(shard.rows_of), shard.unit)
    staged = _stage(F.pad(x, (0, 0, 0, 0, 0, most - x.shape[1]))).contiguous()
    main = shard.rank == 0
    parts = ([torch.empty_like(staged) for _ in range(shard.world)]
             if main else None)
    with _timed(shard, "gather", staged.numel() * staged.element_size()
                * (shard.world - 1) if main else 0, x.device):
        dist.gather(staged, parts, dst=0)
    if not main:
        return None
    return torch.cat([p[:, :n] for p, n in zip(parts, shard.rows_of)],
                     dim=1).to(x.device)
