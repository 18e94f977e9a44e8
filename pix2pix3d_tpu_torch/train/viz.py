"""Visualization helpers, port of `pix2pix3d_tpu/train/viz.py`: mask
colorization and image grids (ref `training/utils.py:3-15`,
`training_loop.py:110-126`).  Grids are written with the port's own PNG
encoder (`utils/png.py`): Pillow is not a dependency of the port."""

from __future__ import annotations

import numpy as np

from ..utils.png import write_png

# 19-color palette (CelebAMask-style) + fallback colors for more classes.
_PALETTE = np.array([
    [0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
    [204, 0, 204], [0, 255, 255], [255, 204, 204], [102, 51, 0], [255, 0, 0],
    [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204], [255, 51, 153],
    [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0]], dtype=np.uint8)


def color_mask(mask):
    """Integer mask `[N, H, W]` -> uint8 RGB `[N, H, W, 3]`."""
    mask = np.asarray(mask).astype(np.int64)
    palette = _PALETTE
    if mask.max() >= len(palette):
        extra = np.random.RandomState(0).randint(
            0, 255, size=(mask.max() + 1 - len(palette), 3), dtype=np.uint8)
        palette = np.concatenate([palette, extra])
    return palette[mask]


def save_image_grid(images, path, grid_cols=None):
    """Save `[N, H, W, C]` images (uint8 range) as one PNG grid; returns
    the grid `[rows * H, cols * W, C]` (uint8)."""
    images = np.asarray(images)
    images = np.clip(np.rint(images), 0, 255).astype(np.uint8)
    n, h, w, c = images.shape
    if grid_cols is None:
        grid_cols = int(np.ceil(np.sqrt(n)))
    grid_rows = int(np.ceil(n / grid_cols))
    grid = np.zeros((grid_rows * h, grid_cols * w, c), dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, grid_cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    write_png(path, grid)
    return grid
