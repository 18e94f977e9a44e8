"""The port's ADA pipeline (`pix2pix3d_tpu_torch/train/augment.py`) against
the JAX package's on the same images and the same random draws.

JAX's pipe runs eagerly with `jax.random.normal`/`uniform`/`randint`
recorded (`recorded`), and the port's draw hooks hand those draws out in
order (`hand_out`), checking each kind and shape.  Cases: every
augmentation alone and `train.py`'s set (the twelve geometric and color
ones), at p=0 and p=1, on 1, 3 and 6 channels (6: the loss's image|raw
pair); `ada_update_p`; and R1's input gradient through the pipe, then
differentiated again, as the R1 phase does.

Tolerances (the reasons): the pipe's outputs within 1e-5 absolute, the
JAX suite's own tolerance for this pipe at p=0 (tests/test_augment.py),
1e-4 with the frequency filter (that file's tolerance for it: its 25-tap
products sum in another order); at p=0 the port returns its input bit for
bit.  R1's gradients: 1e-4 relative + 1e-6 (a second differentiation sums
over pixels and taps in other orders).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.train import augment as jaug

from pix2pix3d_tpu_torch.train import augment as taug

from test_torch_train_phases import two_torch_threads  # noqa: F401  (autouse)

SINGLE = ["xflip", "rotate90", "xint", "scale", "rotate", "aniso", "xfrac",
          "brightness", "contrast", "lumaflip", "hue", "saturation",
          "imgfilter", "noise", "cutout"]
TRAIN_PY = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                saturation=1)          # train.py's augment_kwargs
KINDS = ("normal", "uniform", "randint")


@contextlib.contextmanager
def recorded(out):
    """Record every `jax.random.normal`/`uniform`/`randint` result into
    `out` as (kind, numpy array) while the block runs."""
    orig = {k: getattr(jax.random, k) for k in KINDS}

    def wrap(kind):
        def draw(*args, **kwargs):
            value = orig[kind](*args, **kwargs)
            out.append((kind, np.asarray(value)))
            return value
        return draw
    for k in KINDS:
        setattr(jax.random, k, wrap(k))
    try:
        yield out
    finally:
        for k in KINDS:
            setattr(jax.random, k, orig[k])


@contextlib.contextmanager
def hand_out(draws):
    """The port's augment hooks take `draws` in order; all must be used."""
    queue = list(draws)
    orig = {k: getattr(taug, f"draw_{k}") for k in KINDS}

    def take(kind, shape):
        assert queue, f"the port drew more than JAX ({kind} {shape})"
        got, arr = queue.pop(0)
        assert got == kind and tuple(arr.shape) == tuple(shape), \
            (kind, tuple(shape), got, arr.shape)
        return torch.from_numpy(np.array(arr, np.float32))

    taug.draw_uniform = lambda g, shape, dev: take("uniform", shape).to(dev)
    taug.draw_normal = lambda g, shape, dev: take("normal", shape).to(dev)
    taug.draw_randint = lambda g, lo, hi, shape, dev: take("randint", shape).to(dev)
    try:
        yield
    finally:
        for k in KINDS:
            setattr(taug, f"draw_{k}", orig[k])
    assert not queue, f"the port drew {len(queue)} fewer numbers than JAX"


def both(kwargs, x, p, key=0):
    """(JAX's output, the port's on JAX's draws), numpy."""
    draws = []
    with recorded(draws):
        want = np.asarray(jaug.AugmentPipe(**kwargs)(jax.random.PRNGKey(key),
                                                     jnp.asarray(x), p))
    with hand_out(draws):
        got = taug.AugmentPipe(**kwargs)(torch.from_numpy(x), p, None).numpy()
    return got, want, draws


def images(c, n=4, res=16, seed=0):
    return (np.random.RandomState(seed + c).rand(n, res, res, c)
            .astype(np.float32) * 2 - 1)


@pytest.mark.parametrize("c", [1, 3, 6])
@pytest.mark.parametrize("what", SINGLE + ["train.py"])
def test_pipe_matches_jax(what, c):
    kwargs = TRAIN_PY if what == "train.py" else {what: 1}
    tol = 1e-4 if what == "imgfilter" else 1e-5
    x = images(c)
    for p in (0.0, 1.0):
        got, want, draws = both(kwargs, x, p, key=c)
        assert draws or what in ("hue", "saturation") and c == 1
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"p={p}")
        if p == 0 and what != "imgfilter":
            assert np.array_equal(got, x), "the pipe at p=0 is not the identity"
    if what == "train.py":   # p=1 fires every gate: every image changes
        assert all(not np.allclose(g, a, atol=1e-3) for g, a in zip(got, x))


def test_pipe_on_its_own_generator_is_seeded():
    pipe = taug.AugmentPipe(**TRAIN_PY)
    x = torch.from_numpy(images(6))
    a = pipe(x, 0.5, torch.Generator().manual_seed(3))
    b = pipe(x, 0.5, torch.Generator().manual_seed(3))
    c = pipe(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(pipe(x, 0.0, torch.Generator().manual_seed(3)), x)


def test_freq_bank_matches_jax():
    np.testing.assert_array_equal(taug._make_freq_bank(), jaug._make_freq_bank())


@pytest.mark.parametrize("signs", [-0.3, 0.6, 0.61, 0.95])
def test_ada_update_p_matches_jax(signs):
    for p in (0.0, 0.3, 0.99999, 1.0):
        for kw in (dict(batch_size=4), dict(batch_size=32, ada_interval=8,
                                            ada_kimg=100, ada_target=0.5)):
            assert taug.ada_update_p(p, signs, **kw) == jaug.ada_update_p(p, signs, **kw)


def test_r1_through_the_pipe_matches_jax():
    """R1's penalty |d sum(w * pipe(x)) / dx|^2, differentiated w.r.t. w:
    the double backward through the warp's gathers, the color matrix and
    the frequency filter's grouped convolutions."""
    kwargs = dict(TRAIN_PY, imgfilter=1, noise=1, cutout=1)
    x = images(6, n=2, res=16, seed=5)
    w = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    pipe_j = jaug.AugmentPipe(**kwargs)

    def penalty_j(w):
        def f(x):
            return jnp.sum(jnp.tanh(pipe_j(jax.random.PRNGKey(2), x, 0.7)) * w)
        return jnp.sum(jnp.square(jax.grad(f)(jnp.asarray(x))))

    draws = []
    with recorded(draws):
        want_pen, want_gw = jax.value_and_grad(penalty_j)(jnp.asarray(w))
    # jax.grad traces f once: one set of draws
    pipe_t = taug.AugmentPipe(**kwargs)
    tw = torch.from_numpy(w).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    with hand_out(draws):
        out = (torch.tanh(pipe_t(tx, 0.7, None)) * tw).sum()
    (gx,) = torch.autograd.grad(out, tx, create_graph=True)
    pen = gx.square().sum()
    (gw,) = torch.autograd.grad(pen, tw)
    np.testing.assert_allclose(float(pen.detach()), float(want_pen), rtol=1e-4)
    want_gw = np.asarray(want_gw)
    err = np.abs(gw.numpy() - want_gw).max()
    assert err <= 1e-4 * np.abs(want_gw).max() + 1e-6, err
