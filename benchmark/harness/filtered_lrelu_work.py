"""The least work of StyleGAN3's filtered leaky ReLU, from the layers'
geometry: the reference's layers (`reference/nn/stylegan3.py`) built on
`meta` at the cell's kwargs.  `metrics/filtered_lrelu_roofline.py` divides
its least time by the device time of the `filtered_lrelu` ranges, and
`harness/latent.py` adds its operations to the reference's for `mfu.batch`.

The work is defined so that any implementation reads the same: the
composition of FIR and elementwise passes, one fused kernel, or FIRs on
tensor cores.
- Bytes: each call's input x read once, its bias, and its output y written
  once, in the call's dtype (bf16 in the layers the program runs in bf16,
  the reference's `use_fp16`; f32 elsewhere).
- Operations: 2 x the polyphase multiply-adds of the two filters.  The
  up-FIR (`up` > 1, `up_taps` = filter_size * up) is separable: a
  horizontal pass over the input's rows at every column of the upsampled
  image, then a vertical pass at every upsampled pixel, each output taking
  up_taps / up inputs (the other taps of its window meet inserted zeros,
  which are not counted).  The down-FIR takes `down_taps` inputs per output
  of each separable pass (horizontal at every upsampled row and output
  column, then vertical at every output pixel), or down_taps^2 per output
  pixel where its filter is 2-D (the R configuration's radial filters).  A
  layer without filters (ToRGB) does no FIR work.
"""

from __future__ import annotations

import copy

import torch


def layer_work(layer, batch):
    """(bytes, flops) of one filtered-lrelu call of the reference `layer` at
    `batch` images."""
    side = int(layer.in_size[0]) + layer.conv_kernel - 1     # the modconv's output
    out = int(layer.out_size[0])
    c = layer.out_channels
    elem = 2 if layer.use_fp16 else 4
    n_bytes = elem * (batch * c * side * side + c + batch * c * out * out)
    px0, px1, py0, py1 = layer.padding
    up = layer.up_factor
    mid_w = side * up + px0 + px1 - layer.up_taps + 1       # the upsampled image
    mid_h = side * up + py0 + py1 - layer.up_taps + 1
    macs = 0
    if layer.up_taps > 1:
        macs += batch * c * (side * mid_w + mid_h * mid_w) * (layer.up_taps // up)
    if layer.down_taps > 1:
        if layer.down_radial:
            macs += batch * c * out * out * layer.down_taps ** 2
        else:
            macs += batch * c * (mid_h * out + out * out) * layer.down_taps
    return n_bytes, 2 * macs


def work(synthesis, batch):
    """(bytes, flops) of every layer's call in one forward of the reference
    synthesis network at `batch` images."""
    total_bytes = total_flops = 0
    for name in synthesis.layer_names:
        n_bytes, flops = layer_work(getattr(synthesis, name), batch)
        total_bytes += n_bytes
        total_flops += flops
    return total_bytes, total_flops


def reference_on_meta(gkw):
    """The reference generator of the kwargs `gkw` (with `class_name`), on
    `meta`: shapes and geometry, no data."""
    from reference.nn.stylegan3 import GeneratorS3
    kw = copy.deepcopy(gkw)
    kw.pop("class_name", None)
    with torch.device("meta"):
        return GeneratorS3(**kw)


def cell_work(gkw, batch):
    """(bytes, flops) of one unit of `batch` images of the generator `gkw`."""
    return work(reference_on_meta(gkw).synthesis, batch)
