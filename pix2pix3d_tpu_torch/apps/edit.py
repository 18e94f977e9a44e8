"""Interactive-editing session API, port of `pix2pix3d_tpu/apps/edit.py`
(the headless equivalent of the reference's Qt demo,
`applications/demo/qt_demo_seg2cat.py` + `ui_qt/`).

- per-class brush edits on the label map  -> `set_mask` / `paint`
- yaw/pitch + truncation sliders re-rendering with cached ws
  (ref `qt_demo_seg2cat.py:371-386`)       -> `render(yaw, pitch)`
- "reconstruct" re-running mapping from the edited mask (ref `:202-258`)
                                           -> `reconstruct()`

The planes are cached: a slider move is one renderer + SR pass; the
backbone runs again only after the mask or z changes (an edit drops ws and
the planes).  The session runs on the generator's device.
"""

from __future__ import annotations

import numpy as np

from ..models.triplane import _reshape_planes
from ..render.camera import LookAtPoseSampler, pose_to_conditioning
from .common import (as_f32, device_of, draw_z, inference, intrinsics_for,
                     mask_input, to_numpy)


class EditSession:
    def __init__(self, G, app, mask, seed=0, radius=2.7, pivot=(0, 0, 0),
                 truncation_psi=1.0, z=None):
        """z `[1, z_dim]` (drawn from `seed` if None)."""
        self.G = G
        self.app = app
        self.device = device_of(G)
        self.radius = radius
        self.pivot = list(pivot)
        self.truncation_psi = truncation_psi
        self.z = draw_z(G, seed, self.device) if z is None else as_f32(z, self.device)
        self._ws = None
        self._planes = None
        self.set_mask(mask)

    def _invalidate(self):
        self._ws = None
        self._planes = None

    # ------------------------------------------------------------- mask edit
    def set_mask(self, mask):
        """mask: `[H, W]` or `[H, W, 1]` raw labels / edge uint8."""
        mask = np.asarray(mask)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        self.mask = mask.copy()
        self._invalidate()

    def paint(self, ys, xs, label):
        """Brush: set mask[ys, xs] = label (the demo's per-class brushes)."""
        self.mask[ys, xs] = label
        self._invalidate()

    def set_seed(self, seed):
        self.z = draw_z(self.G, seed, self.device)
        self._invalidate()

    # ------------------------------------------------------------ inference
    def reconstruct(self):
        """Re-run conditional mapping + backbone from the current mask."""
        pose = self._pose(0.0, 0.0)
        batch = {"mask": mask_input(self.G, self.mask, self.device), "pose": pose}
        with inference():
            self._ws = self.G.mapping(self.z, pose, batch,
                                      truncation_psi=self.truncation_psi)
            self._planes = _reshape_planes(
                self.G.backbone.synthesis(self._ws, noise_mode="const"))
        return self._ws

    def _pose(self, yaw, pitch):
        c2w = LookAtPoseSampler.sample(np.pi / 2 + yaw, np.pi / 2 + pitch,
                                       self.pivot, radius=self.radius,
                                       batch_size=1, device=self.device)
        return pose_to_conditioning(c2w, intrinsics_for(self.app, self.device))

    def render(self, yaw=0.0, pitch=0.0):
        """One frame at the given camera offset; returns (rgb, semantic,
        depth) HW[C] numpy arrays.  Cached planes: only renderer + SR run."""
        if self._ws is None:
            self.reconstruct()
        pose = self._pose(yaw, pitch)
        with inference():
            out = self.G.synthesis(
                self._ws, pose,
                neural_rendering_resolution=self.app["neural_rendering_resolution"],
                noise_mode="const", det=True, planes=self._planes)
        return tuple(to_numpy(out[k][0])
                     for k in ("image", "semantic", "image_depth"))
