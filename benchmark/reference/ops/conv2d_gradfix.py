"""A 2D convolution (no padding) whose backward is made of convolutions
that are themselves differentiable: the port's counterpart of the
reference's `torch_utils/ops/conv2d_gradfix.py`.

R1 differentiates the discriminator's input gradient again.  PyTorch's own
convolution double backward computes the weight term as a convolution with
the feature map as its kernel, and loops over the groups of a grouped
(depthwise FIR) convolution; cuDNN runs both on a slow generic kernel in
bf16 (15 s of a 16 s R1 phase at full seg2cat width on the H100).  Here
the input gradient is one transposed convolution and the weight gradient
`convolution_backward`'s, so a second differentiation runs ordinary
convolution kernels.  The values are those of `F.conv2d` and its gradients.
A module flag, as in the reference's module: with `enabled = False`,
`conv2d` is plain `F.conv2d` with PyTorch's own double backward, the
version this one is checked against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

enabled = True


def _conv_input_grad(gy, w, x_shape, stride, groups):
    """The input gradient of `F.conv2d(x, w, stride=stride, groups=groups)`
    (no padding) as one transposed convolution: differentiable again
    through ordinary convolution kernels."""
    kh, kw = w.shape[2:]
    op = [x_shape[2] - ((gy.shape[2] - 1) * stride + kh),
          x_shape[3] - ((gy.shape[3] - 1) * stride + kw)]
    return F.conv_transpose2d(gy, w, stride=stride, output_padding=op,
                              groups=groups)


class _ConvWeightGrad(torch.autograd.Function):
    """The weight gradient of the convolution, with its own backward."""

    @staticmethod
    def forward(ctx, gy, x, w_shape, stride, groups):
        ctx.save_for_backward(gy, x)
        ctx.conf = (stride, groups)
        w = gy.new_empty(w_shape)
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, [stride, stride], [0, 0], [1, 1], False, [0, 0],
            groups, [False, True, False])[1]

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        stride, groups = ctx.conf
        ggy = gx = None
        if ctx.needs_input_grad[0]:
            ggy = F.conv2d(x, ggw, stride=stride, groups=groups)
        if ctx.needs_input_grad[1]:
            gx = _conv_input_grad(gy, ggw, x.shape, stride, groups)
        return ggy, gx, None, None, None


class _Conv2d(torch.autograd.Function):
    """`F.conv2d` without padding, with the backward above."""

    @staticmethod
    def forward(ctx, x, w, stride, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, groups)
        return F.conv2d(x, w, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, groups = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _conv_input_grad(gy, w, x.shape, stride, groups)
        if ctx.needs_input_grad[1]:
            gw = _ConvWeightGrad.apply(gy, x, w.shape, stride, groups)
        return gx, gw, None, None


def conv2d(x, w, stride=1, groups=1):
    """`F.conv2d(x, w, stride=stride, groups=groups)` (no padding, no bias),
    twice differentiable through ordinary convolutions."""
    if not enabled:
        return F.conv2d(x, w, stride=stride, groups=groups)
    return _Conv2d.apply(x, w, stride, groups)
