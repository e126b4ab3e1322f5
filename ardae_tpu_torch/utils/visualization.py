"""The visualization panels of the toy final dump (JAX twin:
ardae_tpu/utils/visualization.py; reference utils/visualization.py).

The numbers are the JAX twin's: ``histogram2d`` is its ``np.histogram2d``
call and ``get_prob_from_energy_func_for_vis`` its probability grid. The
pictures are drawn with numpy alone (no matplotlib): the grid, flipped so
that row 0 is the bottom (imshow's ``origin="lower"``), scaled to its
maximum, coloured by the jet colour table and repeated up to a PANEL x PANEL
x 3 uint8 image, the shape and range of the JAX twin's 5 x 5 inch figure at
100 dpi. The scatter, quiver and grid panels wait with the periodic
visualization (ROADMAP queue 1, slice 6 item 14).
"""

import numpy as np
import torch

PANEL = 500

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
