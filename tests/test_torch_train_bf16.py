"""The discriminator's bf16 blocks (`num_fp16_res`, the recipe's
`--d_num_fp16_res 4`) under R1 against the JAX package and against the same
weights in f32, and the port's convolution whose backward is made of
convolutions (`ops/conv2d_gradfix.py`) against PyTorch's own double
backward (f32) and against f32 (bf16).

R1 differentiates D's input gradient again: `port_r1` below gives the
penalty sum(|dD/dimage|^2) + sum(|dD/dimage_raw|^2) (the R1 phase's, before
its gamma/2 and mean) and its gradient w.r.t. D's parameters.

Tolerances, bf16: both packages round every block's activations and
gradients to bf16 (8 significant bits), at other points and after other
summation orders.  Measured at this size, JAX's bf16 R1 against its own f32
is 0.089 / 0.064 (input gradients, relative L2) and up to 0.081 (a weight's
gradient); the port's bf16 against JAX's bf16 is 0.086 / 0.078 and up to
0.089.  So: forward 2e-2 relative; the penalty 5e-2 relative; input
gradients and each weight's gradient 0.2 relative L2 (twice that noise);
every leaf, biases included, within 0.1 of the network's largest gradient
entry (JAX's bf16 against its f32: 0.10 of a leaf's largest; R1's bias
gradients are ~1e-3 of the weights' and rounding noise in bf16).  f32 (the
gradfix check): 1e-5 of the largest entry, other summation orders.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.nn import discriminator as jdisc

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.nn import discriminator as tdisc
from pix2pix3d_tpu_torch.ops import conv2d_gradfix

from test_torch_train_phases import two_torch_threads  # noqa: F401  (autouse)

D_KW = dict(c_dim=25, img_resolution=64, channel_base=256, channel_max=16,
            num_fp16_res=4, conv_clamp=256, epilogue_kwargs={"mbstd_group_size": 2})


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def from_nhwc(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 3, 64, 64).astype(np.float32),
            rng.randn(2, 3, 16, 16).astype(np.float32),
            rng.randn(2, 25).astype(np.float32))


def port_r1(D, img, raw, c):
    """(logits sum, input gradients, penalty, {param: gradient}) of the
    port's D at f32 inputs."""
    ti = torch.from_numpy(img).requires_grad_(True)
    tr = torch.from_numpy(raw).requires_grad_(True)
    out = D({"image": ti, "image_raw": tr}, torch.from_numpy(c)).sum()
    gi, gr = torch.autograd.grad(out, [ti, tr], create_graph=True)
    pen = gi.float().square().sum() + gr.float().square().sum()
    names = [n for n, _ in D.named_parameters()]
    grads = torch.autograd.grad(pen, list(D.parameters()), allow_unused=True)
    return (out.item(), (gi.detach().numpy(), gr.detach().numpy()), pen.item(),
            {n: None if g is None else g.float().numpy() for n, g in zip(names, grads)})


@pytest.fixture(scope="module")
def r1_pair():
    """JAX's bf16 R1 (one jit for the module) and the port's, same weights."""
    jm = jdisc.DualDiscriminator(img_channels=3, **D_KW)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(4)))
    img, raw, c = _inputs()

    def logits(p, i, r):
        return jnp.sum(jm(p, {"image": i, "image_raw": r}, jnp.asarray(c)))

    def r1(p, i, r):
        gi, gr = jax.grad(logits, argnums=(1, 2))(p, i, r)
        pen = jnp.sum(gi.astype(jnp.float32) ** 2) + jnp.sum(gr.astype(jnp.float32) ** 2)
        return pen, (logits(p, i, r), gi, gr)

    (pen, (out, gi, gr)), gp = jax.jit(jax.value_and_grad(r1, has_aux=True))(
        params, nhwc(img), nhwc(raw))
    want = (float(out), (from_nhwc(gi), from_nhwc(gr)), float(pen),
            {k: v.numpy() for k, v in
             bridge.params_from_jax(jax.device_get(gp)).items()})
    tm = tdisc.DualDiscriminator(img_channels=3, **D_KW)
    tm.load_state_dict(bridge.params_from_jax(params), strict=True)
    return port_r1(tm, img, raw, c), want, tm


def test_bf16_discriminator_forward_matches_jax(r1_pair):
    got, want, _ = r1_pair
    assert abs(got[0] - want[0]) <= 2e-2 * abs(want[0])


def test_bf16_r1_input_gradient_and_penalty_match_jax(r1_pair):
    got, want, _ = r1_pair
    for g, w in zip(got[1], want[1]):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert rel_l2(g, w) <= 0.2
    assert abs(got[2] - want[2]) <= 5e-2 * abs(want[2])


def test_bf16_r1_parameter_gradient_matches_jax(r1_pair):
    got, want, _ = r1_pair
    scale = max(np.abs(w).max() for w in want[3].values())
    assert set(got[3]) == set(want[3])
    for name, w in want[3].items():
        g = got[3][name]
        g = np.zeros_like(w) if g is None else g  # no path to the penalty
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= 0.1 * scale, name
        if name.endswith("weight"):
            assert rel_l2(g, w) <= 0.2, name


def test_bf16_r1_through_gradfix_is_near_the_f32_r1(r1_pair):
    """The recipe's bf16 D against the same weights in f32 (num_fp16_res
    0): R1's input gradients and each weight's gradient within the bf16
    bounds above."""
    got, _, tm = r1_pair
    f32 = tdisc.DualDiscriminator(img_channels=3, **dict(D_KW, num_fp16_res=0))
    f32.load_state_dict(tm.state_dict(), strict=True)
    want = port_r1(f32, *_inputs())
    for g, w in zip(got[1], want[1]):
        assert rel_l2(g, w) <= 0.2
    for name, w in want[3].items():
        if w is not None and name.endswith("weight"):
            assert rel_l2(got[3][name], w) <= 0.2, name


@pytest.mark.parametrize("channels,size", [(4, 66), (16, 34)])
def test_gradfix_bf16_double_backward_is_near_f32(channels, size):
    """R1's weight term through one bf16 convolution at a D block's sizes
    (b64.conv0 of D_KW is 4 channels at 66^2): within 2e-2 relative L2 of
    f32.  (PyTorch's own bf16 double backward on the CPU is not: 0.99 at
    these sizes, the reason the check is against f32.)"""
    rng = np.random.RandomState(channels)
    x0 = torch.from_numpy(rng.randn(2, channels, size, size).astype(np.float32))
    w0 = torch.from_numpy(0.1 * rng.randn(channels, channels, 3, 3).astype(np.float32))
    gy = torch.from_numpy(rng.randn(2, channels, size - 2, size - 2).astype(np.float32))

    def weight_term(dtype):
        x = x0.to(dtype).requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        y = conv2d_gradfix.conv2d(x, w.to(dtype))
        gx, = torch.autograd.grad((y.float() * gy).sum(), [x], create_graph=True)
        return torch.autograd.grad(gx.float().square().sum(), [w])[0].numpy()

    assert rel_l2(weight_term(torch.bfloat16), weight_term(torch.float32)) <= 2e-2


@pytest.mark.parametrize("stride,groups,cin,k", [
    (1, 1, 4, 3),      # a plain 3x3 convolution
    (2, 1, 4, 3),      # a strided one (conv2d_resample's down=2 path)
    (1, 4, 4, 4),      # a depthwise FIR filter (upfirdn2d)
    (1, 2, 4, 1),      # grouped 1x1
])
def test_gradfix_double_backward_matches_pytorch(stride, groups, cin, k):
    """Value, first and second derivatives of an R1-like penalty through
    `conv2d_gradfix.conv2d` equal `F.conv2d`'s (f32)."""
    rng = np.random.RandomState(stride * 10 + groups)
    x0 = torch.from_numpy(rng.randn(2, cin, 11, 12).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(6 if groups < cin else cin, cin // groups, k, k)
                          .astype(np.float32))

    def second_order(conv):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y = conv(x, w, stride=stride, groups=groups)
        gx, gw = torch.autograd.grad(y.square().sum(), [x, w], create_graph=True)
        pen = gx.square().sum() + gw.square().sum()
        return [y.detach(), gx.detach(), gw.detach(),
                *torch.autograd.grad(pen, [x, w])]

    got = second_order(conv2d_gradfix.conv2d)
    want = second_order(F.conv2d)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
