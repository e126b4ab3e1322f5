"""The visualization panels of the drivers' periodic ``visualize`` and of
the toy final dump (JAX twin: ardae_tpu/utils/visualization.py; reference
utils/visualization.py).

The numbers are the JAX twin's: ``histogram2d`` is its ``np.histogram2d``
call, ``get_prob_from_energy_func_for_vis`` its probability grid and
``get_grid_image`` its image grid, copied. The pictures are drawn with numpy
alone (no matplotlib), each a PANEL x PANEL x 3 uint8 image, the shape and
range of the JAX twin's 5 x 5 inch figure at 100 dpi: a grid is flipped so
that row 0 is the bottom (imshow's ``origin="lower"``), scaled to its
maximum, coloured by the jet colour table and repeated up to the panel; a
scatter lays each point as a 2 x 2-pixel mark of matplotlib's first colour
at its alpha over a white field, y up; a 1-D histogram draws its density
bars in that colour; a quiver draws one black arrow per grid point, its
length scaled as matplotlib's autoscale does. ``save_png`` writes a panel
as a PNG with ``zlib`` and ``struct`` alone, for the examples: the card has
neither matplotlib nor PIL.
"""

import math
import struct
import zlib

import numpy as np
import torch

PANEL = 500
_C0 = np.array([31.0, 119.0, 180.0])   # matplotlib's first colour, #1f77b4

# matplotlib's "jet": (position, value) knots of each channel
_JET = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)


def convert_npimage_torchimage(image):
    """HWC [0..255] -> CHW float in [0, 1] (reference :16-17)."""
    return np.transpose(image, (2, 0, 1)).astype(np.float32) / 255.0


def get_imshow_plot(grid):
    """A (rows, cols) grid (a probability grid, histogram counts) as a
    PANEL x PANEL x 3 uint8 jet image, row 0 at the bottom, scaled to the
    grid's maximum (reference :137-159, :193-228)."""
    g = np.asarray(grid, np.float64)[::-1]
    top = g.max()
    v = g / top if top > 0 else np.zeros_like(g)
    rgb = np.stack([np.interp(v, *zip(*knots)) for knots in _JET], axis=-1)
    rows = np.arange(PANEL) * g.shape[0] // PANEL
    cols = np.arange(PANEL) * g.shape[1] // PANEL
    return np.round(255.0 * rgb[rows][:, cols]).astype(np.uint8)


def get_prob_from_energy_func_for_vis(energy_func, val=4, num=256):
    """exp(-energy) over a num x num grid of [-val, val]^2 (x along the
    columns), scaled to its maximum (reference :123-135); fp32, as the JAX
    twin."""
    lin = np.linspace(-val, val, num)
    xv, yv = np.meshgrid(lin, lin)
    pts = torch.as_tensor(np.stack([xv.reshape(-1), yv.reshape(-1)], axis=1),
                          dtype=torch.float32)
    energy = energy_func(pts).numpy().reshape(num, num)
    prob = np.exp(-energy)
    return prob / max(prob.max(), 1e-12)


def histogram2d(data, val=4, num=128):
    """Counts of the points (N, 2) in num x num bins over [-val, val]^2,
    rows along y: the grid of get_2d_histogram_plot (reference
    :193-228)."""
    counts, _, _ = np.histogram2d(data[:, 1], data[:, 0], bins=num,
                                  range=[[-val, val], [-val, val]])
    return counts


def get_2d_histogram_plot(data, val=4, num=128):
    """The counts of the points (N, 2) in num x num bins over [-val, val]^2
    as a jet panel (reference :193-228)."""
    return get_imshow_plot(histogram2d(data, val=val, num=num))


def _pixels(v, lim):
    """Panel pixel index of coordinates in [-lim, lim]; -1 outside."""
    with np.errstate(invalid="ignore"):
        inside = np.isfinite(v) & (v >= -lim) & (v <= lim)
    idx = np.floor((np.where(inside, v, 0.0) + lim) / (2.0 * lim) * PANEL)
    return np.where(inside, np.minimum(idx, PANEL - 1), -1).astype(np.int64)


def get_scatter_plot(data, xlim=4, ylim=4, alpha=0.1):
    """The points (N, 2) over [-xlim, xlim] x [-ylim, ylim], y up, each a
    2 x 2-pixel mark at ``alpha`` over white (reference :19-60): a pixel
    under n marks is white * (1 - alpha)^n plus the colour for the rest."""
    data = np.asarray(data, np.float64)
    col, row = _pixels(data[:, 0], xlim), _pixels(data[:, 1], ylim)
    keep = (col >= 0) & (row >= 0)
    col, row = col[keep], PANEL - 1 - row[keep]
    hits = np.zeros((PANEL, PANEL), np.int64)
    for dr in (0, 1):
        for dc in (0, 1):
            np.add.at(hits, (np.minimum(row + dr, PANEL - 1),
                             np.minimum(col + dc, PANEL - 1)), 1)
    cover = 1.0 - (1.0 - alpha) ** hits
    rgb = 255.0 * (1.0 - cover)[..., None] + cover[..., None] * _C0
    return np.round(rgb).astype(np.uint8)


def get_1d_histogram_plot(data, val=4, num=128):
    """The density histogram of ``data`` in num bins over (-val, val), bars
    in matplotlib's first colour on white, scaled to the highest bar
    (reference :161-191)."""
    dens, _ = np.histogram(np.asarray(data).reshape(-1), bins=num,
                           range=(-val, val), density=True)
    top = dens.max() if dens.size and np.isfinite(dens).all() else 0.0
    height = np.round(PANEL * (dens / top if top > 0 else np.zeros_like(dens)))
    cols = height[np.arange(PANEL) * num // PANEL]
    filled = np.arange(PANEL)[::-1, None] < cols[None, :]
    img = np.full((PANEL, PANEL, 3), 255.0)
    img[filled] = _C0
    return img.astype(np.uint8)


def get_data_for_quiver_plot(val=4, num=20):
    """A num x num grid over [-val, val]^2: its points (num^2, 2) float32
    and the meshgrid (reference :63-69)."""
    lin = np.linspace(-val, val, num)
    xs, ys = np.meshgrid(lin, lin)
    data = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1).astype(np.float32)
    return data, xs, ys


def get_quiver_plot(grad, xs, ys, xlim=4.5, ylim=4.5):
    """The vector field ``grad`` (N, 2) at the grid points ``xs``, ``ys``
    over [-xlim, xlim] x [-ylim, ylim], y up: a black arrow from each point
    on white (reference :71-120). Lengths follow matplotlib's autoscale
    (``Quiver``'s scale = 1.8 x the mean arrow length x max(10, sqrt(N)) a
    panel width), so the mean arrow is a panel width over 1.8 max(10,
    sqrt(N)), about half a cell of a 41 x 41 grid; the head is two strokes
    at +-25 degrees, a third of the arrow long."""
    g = np.asarray(grad, np.float64).reshape(-1, 2)
    px = np.asarray(xs, np.float64).reshape(-1)
    py = np.asarray(ys, np.float64).reshape(-1)
    mag = np.hypot(g[:, 0], g[:, 1])
    keep = np.isfinite(mag) & np.isfinite(px) & np.isfinite(py)
    g, px, py, mag = g[keep], px[keep], py[keep], mag[keep]
    img = np.full((PANEL, PANEL, 3), 255, np.uint8)
    amean = float(mag.mean()) if mag.size else 0.0
    if amean <= 0.0:
        return img
    per_unit = PANEL / (1.8 * amean * max(10.0, math.sqrt(g.shape[0])))
    # panel pixels (column right, row down) of the tails and the vectors
    col = (px + xlim) / (2.0 * xlim) * PANEL
    row = PANEL - (py + ylim) / (2.0 * ylim) * PANEL
    dc, dr = g[:, 0] * per_unit, -g[:, 1] * per_unit
    strokes = [(col, row, dc, dr)]
    for turn in (math.radians(155.0), -math.radians(155.0)):
        c, s = math.cos(turn), math.sin(turn)
        strokes.append((col + dc, row + dr, (c * dc - s * dr) / 3.0,
                        (s * dc + c * dr) / 3.0))
    steps = int(math.ceil(float(np.max(np.hypot(dc, dr))))) + 2
    frac = np.linspace(0.0, 1.0, steps)[:, None]
    for c0, r0, vc, vr in strokes:
        cc = np.floor(c0[None, :] + frac * vc[None, :]).astype(np.int64).ravel()
        rr = np.floor(r0[None, :] + frac * vr[None, :]).astype(np.int64).ravel()
        inside = (cc >= 0) & (cc < PANEL) & (rr >= 0) & (rr < PANEL)
        img[rr[inside], cc[inside]] = 0
    return img


def save_png(path, img):
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG: the signature,
    IHDR, one zlib-compressed IDAT of filter-0 scanlines, IEND."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png takes (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    hgt, wid = img.shape[:2]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((hgt, 1), np.uint8), img.reshape(hgt, -1)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", wid, hgt, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def get_grid_image(images, batch_size, nchannels, nheight, nrow=8, pad=2):
    """Image grid -> CHW float in [0,1] (reference :230-238 wraps
    vutils.make_grid); pure-numpy implementation."""
    imgs = np.asarray(images).reshape(batch_size, nchannels, nheight, nheight)
    imgs = np.clip(imgs, 0.0, 1.0)
    n = min(batch_size, 64)
    ncol = min(nrow, n)
    nrows = math.ceil(n / ncol)
    H = nrows * (nheight + pad) + pad
    W = ncol * (nheight + pad) + pad
    grid = np.zeros((nchannels, H, W), np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        y = pad + r * (nheight + pad)
        x = pad + c * (nheight + pad)
        grid[:, y : y + nheight, x : x + nheight] = imgs[i]
    return grid
