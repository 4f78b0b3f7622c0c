"""MASA cross-image patch search and transfer, in plain PyTorch.

Counterpart of textualdegremoval_tpu/ops/masa.py, function by function, so
each stage can be compared with its JAX twin: coarse search on the deepest
feature, window corners, window gather at every pyramid level, fine search,
and the selection-count transfer.  The JAX package's custom-vjp gather and
shifted-slice unfolds work around XLA lowering; here the gather is advanced
indexing and the block extraction is `Tensor.unfold`.

Correlation products take their multiplicands in the input dtype, widened
to f32 (exact products, f32 sums), as `preferred_element_type=f32` does in
the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from textualdegremoval_tpu_torch.parallel.spatial import exchange_rows


def unfold_nhwc(x: torch.Tensor, ks: int) -> torch.Tensor:
    """torch F.unfold-compatible patch extraction on NHWC, stride 1, no
    padding (JAX `unfold_nhwc` at its defaults): (N, H, W, C) ->
    (N, H - ks + 1, W - ks + 1, C * ks * ks), the last axis channel-major,
    index c * ks * ks + ki * ks + kj."""
    n, h, w, c = x.shape
    oh, ow = h - ks + 1, w - ks + 1
    taps = [x[:, i: i + oh, j: j + ow, :] for i in range(ks)
            for j in range(ks)]
    return torch.stack(taps, dim=-1).reshape(n, oh, ow, c * ks * ks)


def masa_coarse_search(lq_blocks: torch.Tensor, ref_feat: torch.Tensor,
                       dilations=(1, 2, 3)) -> torch.Tensor:
    """Multi-dilation centre-patch correlation, top-1 over ref positions.

    lq_blocks: (N, pb, ky+2, kx+2, C) haloed LQ blocks; ref_feat:
    (N, Hr, Wr, C).  Returns (N, pb) int32 flat indices into Hr*Wr."""
    n, pb, kyh, kxh, c = lq_blocks.shape
    _, hr, wr, _ = ref_feat.shape
    cy, cx = kyh // 2, kxh // 2
    dilations = [
        d for d in dilations
        if cy - d >= 0 and cy + d < kyh and cx - d >= 0 and cx + d < kxh
    ] or [1]

    sq = ref_feat.float().square().sum(dim=-1)
    corr_sum = torch.zeros((n, pb, hr * wr), dtype=torch.float32,
                           device=ref_feat.device)
    for d in dilations:
        patch = lq_blocks[:, :, cy - d: cy + d + 1: d,
                          cx - d: cx + d + 1: d, :].float()
        pnorm = patch.square().sum(dim=(2, 3, 4)).sqrt()
        patch = patch.reshape(n, pb, 9 * c)

        refp = F.pad(ref_feat, (0, 0, d, d, d, d))
        sqp = F.pad(sq, (d, d, d, d))
        shifts = []
        rn2 = torch.zeros((n, hr, wr), dtype=torch.float32,
                          device=ref_feat.device)
        for a in range(3):
            for b in range(3):
                shifts.append(refp[:, a * d: a * d + hr, b * d: b * d + wr, :])
                rn2 = rn2 + sqp[:, a * d: a * d + hr, b * d: b * d + wr]
        ref_cat = torch.cat(shifts, dim=-1).reshape(n, hr * wr, 9 * c).float()
        rnorm = rn2.sqrt().reshape(n, hr * wr)

        raw = torch.einsum("npk,nrk->npr", patch, ref_cat)
        denom = (torch.clamp_min(pnorm, 1e-12)[:, :, None]
                 * torch.clamp_min(rnorm, 1e-12)[:, None, :])
        corr_sum = corr_sum + raw / denom
    return torch.argmax(corr_sum, dim=-1).to(torch.int32)


def masa_window_corners(index: torch.Tensor, hr: int, wr: int,
                        diameter_y: int, diameter_x: int):
    """Flat top-1 indices -> clamped window corners (y1, x1); the window is
    [y1, y1 + diameter_y + 2) x [x1, x1 + diameter_x + 2)."""
    idx_x = index % wr
    idx_y = index // wr
    x1 = torch.clamp(idx_x - diameter_x // 2 - 1, 0, wr - diameter_x - 2)
    y1 = torch.clamp(idx_y - diameter_y // 2 - 1, 0, hr - diameter_y - 2)
    return y1, x1


def masa_gather_windows(feat: torch.Tensor, y1: torch.Tensor,
                        x1: torch.Tensor, d2y: int, d2x: int,
                        scale: int) -> torch.Tensor:
    """Per-block ref windows of one pyramid level.

    feat: (N, Hr*scale, Wr*scale, C); y1, x1: (N, pb) corners at deepest
    scale.  Returns (N, pb, d2y*scale, d2x*scale, C)."""
    n = feat.shape[0]
    dev = feat.device
    rows = (y1.long() * scale)[..., None] + torch.arange(d2y * scale,
                                                         device=dev)
    cols = (x1.long() * scale)[..., None] + torch.arange(d2x * scale,
                                                         device=dev)
    bidx = torch.arange(n, device=dev)[:, None, None, None]
    return feat[bidx, rows[:, :, :, None], cols[:, :, None, :]]


def _cat_and_norm(x: torch.Tensor, oy: int, ox: int, psize: int):
    nb = x.shape[0]
    sqm = x.float().square().sum(dim=-1)
    views = []
    n2 = torch.zeros((nb, oy, ox), dtype=torch.float32, device=x.device)
    for a in range(psize):
        for b in range(psize):
            views.append(x[:, a: a + oy, b: b + ox, :])
            n2 = n2 + sqm[:, a: a + oy, b: b + ox]
    cat = torch.cat(views, dim=-1).reshape(nb, oy * ox, -1)
    return cat, n2.sqrt().reshape(nb, oy * ox)


def masa_fine_search(lq_blocks: torch.Tensor, ref_windows: torch.Tensor,
                     psize: int = 3):
    """Dense valid psize x psize correlation of LQ block patches against ref
    window patches.

    lq_blocks: (NB, ky+2, kx+2, C); ref_windows: (NB, d2y, d2x, C).
    Returns index (NB, ky, kx) int32 into the (d2y-2)*(d2x-2) patch grid and
    soft_att (NB, ky, kx) f32, the top-1 score."""
    nb, kyh, kxh, _ = lq_blocks.shape
    _, d2y, d2x, _ = ref_windows.shape
    ky, kx = kyh - 2, kxh - 2
    ry, rx = d2y - psize + 1, d2x - psize + 1
    lq_cat, lnorm = _cat_and_norm(lq_blocks, ky, kx, psize)
    ref_cat, rnorm = _cat_and_norm(ref_windows, ry, rx, psize)
    raw = torch.einsum("nlk,nrk->nlr", lq_cat.float(), ref_cat.float())
    corr = raw / (torch.clamp_min(lnorm, 1e-12)[:, :, None]
                  * torch.clamp_min(rnorm, 1e-12)[:, None, :])
    index = torch.argmax(corr, dim=-1)
    soft = torch.gather(corr, -1, index[..., None])[..., 0]
    return (index.to(torch.int32).reshape(nb, ky, kx),
            soft.reshape(nb, ky, kx))


def _transfer_weights(index: torch.Tensor, psize: int, d2y: int, d2x: int):
    """Selection-count matrix of the MASA fold.

    W[l, p] counts the psize^2 neighbouring grid cells of output cell l that
    selected window tile p; cnt[l] counts the in-bounds neighbours (the fold
    divisor).  Returns (W (NB, ky*kx, d2y*d2x) f32, cnt (1, ky, kx, 1) f32)."""
    nb, ky, kx = index.shape
    dev = index.device
    rx = d2x - psize + 1
    half = psize // 2
    iy = index.long() // rx
    ix = index.long() % rx
    cells = torch.arange(d2y * d2x, device=dev)
    w = torch.zeros((nb, ky * kx, d2y * d2x), dtype=torch.float32, device=dev)
    cnt = torch.zeros((1, ky, kx, 1), dtype=torch.float32, device=dev)
    for a in range(psize):
        oy = a - half
        for b in range(psize):
            ox = b - half
            ly0, ly1 = max(0, oy), min(ky, ky + oy)
            lx0, lx1 = max(0, ox), min(kx, kx + ox)
            iy_sh = torch.roll(iy, (oy, ox), dims=(1, 2))
            ix_sh = torch.roll(ix, (oy, ox), dims=(1, 2))
            g = (iy_sh + a) * d2x + (ix_sh + b)
            valid = torch.zeros((1, ky, kx, 1), dtype=torch.float32,
                                device=dev)
            valid[:, ly0:ly1, lx0:lx1] = 1.0
            onehot = (g.reshape(nb, ky * kx, 1) == cells).float()
            w = w + onehot * valid.reshape(1, ky * kx, 1)
            cnt = cnt + valid
    return w, cnt


def masa_transfer(ref_window: torch.Tensor, index: torch.Tensor,
                  soft_att: torch.Tensor, psize: int,
                  scale: int) -> torch.Tensor:
    """Warp a ref window onto the LQ block grid at one pyramid scale:
    out = (W @ tiles) / cnt, scaled by the bilinearly resized soft score.

    ref_window: (NB, d2y*scale, d2x*scale, C_s); index, soft_att:
    (NB, ky, kx).  Returns (NB, ky*scale, kx*scale, C_s)."""
    nb, ky, kx = index.shape
    s = scale
    hs, ws, c = ref_window.shape[1:]
    d2y, d2x = hs // s, ws // s
    dt = ref_window.dtype

    tiles = ref_window.reshape(nb, d2y, s, d2x, s, c).permute(0, 1, 3, 2, 4, 5)
    tiles = tiles.reshape(nb, d2y * d2x, s * s * c)
    w, cnt = _transfer_weights(index, psize, d2y, d2x)
    out = torch.einsum("nlp,npc->nlc", w, tiles.float())
    out = out.reshape(nb, ky, kx, s * s * c) / cnt
    acc_dt = torch.float32 if dt == torch.float32 else dt
    out = out.to(acc_dt)
    out = out.reshape(nb, ky, kx, s, s, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(nb, ky * s, kx * s, c)
    att = F.interpolate(soft_att[:, None].float(), size=(ky * s, kx * s),
                        mode="bilinear", align_corners=False)
    return (out * att.permute(0, 2, 3, 1).to(acc_dt)).to(dt)


def _blocks_to_image(x: torch.Tensor, n: int, py: int, px: int):
    """(N*py*px, bh, bw, C) -> (N, py*bh, px*bw, C)."""
    _, bh, bw, c = x.shape
    x = x.reshape(n, py, px, bh, bw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, py * bh, px * bw, c)


def masa_match_and_warp(feat_lq_deep: torch.Tensor,
                        feat_ref_pyramid: list[torch.Tensor],
                        lr_block_size: int, ref_down_block_size: float = 1.5,
                        psize: int = 3, dilations=(1, 2, 3), shard=None):
    """Full MASA: coarse search on the deepest level, window gather at every
    level, fine search, transfer.

    feat_lq_deep: (N, H, W, C) deepest LQ feature; feat_ref_pyramid: S ref
    features shallow -> deep.  Returns the warped pyramid shallow -> deep,
    aligned to the LQ frame.

    shard: a parallel.spatial.RowShard at the deepest level where
    feat_lq_deep is one rank's slab of a row-sharded image, whose rows are
    whole block rows.  The block grid and the window diameters come from
    the image's height (shard.height), the blocks' 1-row halo from the
    neighbours at the slab's edges (replicated only at the image's), and
    each rank searches and warps its own block rows against the whole
    reference: the warped pyramid of its slab."""
    n, h, w, c = feat_lq_deep.shape
    deep_ref = feat_ref_pyramid[-1]
    _, hr, wr, _ = deep_ref.shape
    nscales = len(feat_ref_pyramid)
    hg = h if shard is None else shard.height

    px = max(w // lr_block_size, 1)
    py = max(hg // lr_block_size, 1)
    kx = w // px
    ky = hg // py
    diameter_x = min(2 * int(wr / (2 * px) * ref_down_block_size) + 1, wr - 2)
    diameter_y = min(2 * int(hr / (2 * py) * ref_down_block_size) + 1, hr - 2)
    d2y, d2x = diameter_y + 2, diameter_x + 2

    # haloed (ky+2, kx+2) LQ blocks at stride (ky, kx), replicate border
    if shard is None:
        lq_pad = F.pad(feat_lq_deep.permute(0, 3, 1, 2), (1, 1, 1, 1),
                       mode="replicate")
    else:
        if h % ky:
            raise ValueError(f"masa_match_and_warp: a slab of {h} rows is not "
                             f"whole block rows of {ky}")
        py = h // ky
        ext = exchange_rows(feat_lq_deep, 1, shard)
        if shard.up is None:
            ext[:, :1] = feat_lq_deep[:, :1]
        if shard.down is None:
            ext[:, -1:] = feat_lq_deep[:, -1:]
        lq_pad = F.pad(ext.permute(0, 3, 1, 2), (1, 1, 0, 0),
                       mode="replicate")
    bl = lq_pad.unfold(2, ky + 2, ky).unfold(3, kx + 2, kx)[:, :, :py, :px]
    lq_blocks = bl.permute(0, 2, 3, 4, 5, 1).reshape(n, py * px, ky + 2,
                                                     kx + 2, c)

    top1 = masa_coarse_search(lq_blocks, deep_ref, dilations)
    y1, x1 = masa_window_corners(top1, hr, wr, diameter_y, diameter_x)

    win_deep = masa_gather_windows(deep_ref, y1, x1, d2y, d2x, 1)
    nb = n * py * px
    index, soft_att = masa_fine_search(
        lq_blocks.reshape(nb, ky + 2, kx + 2, c),
        win_deep.reshape(nb, d2y, d2x, c), psize)

    warps = []
    for level in range(nscales):
        scale = 2 ** (nscales - 1 - level)
        feat = feat_ref_pyramid[level]
        win = masa_gather_windows(feat, y1, x1, d2y, d2x, scale)
        win = win.reshape(nb, d2y * scale, d2x * scale, feat.shape[-1])
        warped = masa_transfer(win, index, soft_att, psize, scale)
        warps.append(_blocks_to_image(warped, n, py, px))
    return warps
