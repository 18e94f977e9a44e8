"""Optional Weights & Biases sink, port of `pix2pix3d_tpu/train/wandb_sink.py`
(ref `training/training_loop.py:396-399` init, per-tick scalars, image
tables `:150-225`).

A no-op unless the `wandb` package imports and `PIX2PIX3D_WANDB` names a
project; stats.jsonl and the TensorBoard event file are written either way.
"""

from __future__ import annotations

import os
import warnings


class WandbSink:
    def __init__(self, run_dir, config=None, run_name=None):
        self._run = None
        project = os.environ.get("PIX2PIX3D_WANDB")
        if not project:
            return
        try:
            import wandb
        except ImportError:
            warnings.warn("PIX2PIX3D_WANDB set but the wandb package is not "
                          "installed; scalar/image logs go to stats.jsonl + "
                          "TensorBoard only.")
            return
        self._wandb = wandb
        self._run = wandb.init(project=project, dir=run_dir,
                               name=run_name or os.path.basename(run_dir),
                               config=config or {}, resume="allow")

    @property
    def enabled(self):
        return self._run is not None

    def log_scalars(self, fields, step):
        """Per-tick scalar dict (ref `training_loop.py:789-795`)."""
        if self._run is not None:
            self._run.log(dict(fields), step=int(step))

    def log_images(self, name, images_uint8, step, caption=None):
        """[N, H, W, C] uint8 grid entries (ref image tables `:150-225`)."""
        if self._run is None:
            return
        imgs = [self._wandb.Image(im, caption=caption) for im in images_uint8]
        self._run.log({name: imgs}, step=int(step))

    def finish(self):
        if self._run is not None:
            self._run.finish()
            self._run = None
