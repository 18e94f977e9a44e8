"""Inception-v3 pool3 features (2048-d) and classifier logits for exact FID,
KID, precision/recall and the Inception Score; port of
`pix2pix3d_tpu/metrics/inception.py`, NCHW.

torchvision's `inception_v3` graph on weights in the `.npz` layout that
scripts/convert_inception.py writes: torchvision's state_dict keys with '.'
-> '/', convolutions HWIO, `fc/weight` `[1000, 2048]` as torchvision stores
it (the JAX module transposes it on use; so does this one, through
`F.linear`).  `INCEPTION_SHAPES` is every key and shape of that file
(torchvision's model with its auxiliary classifier, which the features do
not use, and BatchNorm's `num_batches_tracked`): a loaded file is checked
against it key by key, and `random_inception_weights` draws a file's worth
of random weights from it (He-scaled convolutions, BatchNorm mean 0 and
variance 1, so that activations stay finite through the 17 blocks).  The
tree holds no converted weights, so numbers on random weights say only that
the network runs.

Preprocessing as the JAX module's: a resize to 299² as `jax.image.resize(...,
"linear", antialias=True)` computes it (`ops/resize.resize_bilinear`;
`F.interpolate`'s antialias filter and edges differ), /255, ImageNet
mean/std.  The 3x3 average pools divide by the count of valid taps, the max
pools are VALID 3x3 stride 2, BatchNorm's eps is 1e-3.

Precision: every convolution, product and the resize run on f32 tensors
with TF32 off (`ops/precision.policy(False)`), so that the card's features
are comparable with the JAX package's at full f32 precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import precision
from ..ops.resize import resize_bilinear
from .metric_utils import images_to

BN_EPS = 1e-3
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _spec(table, name, cin, cout, k, stride=1, pad=0):
    kh, kw = (k, k) if isinstance(k, int) else k
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    table[name] = (cin, cout, kh, kw, stride, ph, pw)


def _conv_table():
    """{name: (in, out, kh, kw, stride, pad_h, pad_w)} of every BasicConv2d
    of torchvision's Inception3, auxiliary classifier included."""
    t = {}
    _spec(t, "Conv2d_1a_3x3", 3, 32, 3, stride=2)
    _spec(t, "Conv2d_2a_3x3", 32, 32, 3)
    _spec(t, "Conv2d_2b_3x3", 32, 64, 3, pad=1)
    _spec(t, "Conv2d_3b_1x1", 64, 80, 1)
    _spec(t, "Conv2d_4a_3x3", 80, 192, 3)
    for name, cin, pool in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                            ("Mixed_5d", 288, 64)):
        _spec(t, f"{name}/branch1x1", cin, 64, 1)
        _spec(t, f"{name}/branch5x5_1", cin, 48, 1)
        _spec(t, f"{name}/branch5x5_2", 48, 64, 5, pad=2)
        _spec(t, f"{name}/branch3x3dbl_1", cin, 64, 1)
        _spec(t, f"{name}/branch3x3dbl_2", 64, 96, 3, pad=1)
        _spec(t, f"{name}/branch3x3dbl_3", 96, 96, 3, pad=1)
        _spec(t, f"{name}/branch_pool", cin, pool, 1)
    _spec(t, "Mixed_6a/branch3x3", 288, 384, 3, stride=2)
    _spec(t, "Mixed_6a/branch3x3dbl_1", 288, 64, 1)
    _spec(t, "Mixed_6a/branch3x3dbl_2", 64, 96, 3, pad=1)
    _spec(t, "Mixed_6a/branch3x3dbl_3", 96, 96, 3, stride=2)
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        _spec(t, f"{name}/branch1x1", 768, 192, 1)
        _spec(t, f"{name}/branch7x7_1", 768, c7, 1)
        _spec(t, f"{name}/branch7x7_2", c7, c7, (1, 7), pad=(0, 3))
        _spec(t, f"{name}/branch7x7_3", c7, 192, (7, 1), pad=(3, 0))
        _spec(t, f"{name}/branch7x7dbl_1", 768, c7, 1)
        _spec(t, f"{name}/branch7x7dbl_2", c7, c7, (7, 1), pad=(3, 0))
        _spec(t, f"{name}/branch7x7dbl_3", c7, c7, (1, 7), pad=(0, 3))
        _spec(t, f"{name}/branch7x7dbl_4", c7, c7, (7, 1), pad=(3, 0))
        _spec(t, f"{name}/branch7x7dbl_5", c7, 192, (1, 7), pad=(0, 3))
        _spec(t, f"{name}/branch_pool", 768, 192, 1)
    _spec(t, "AuxLogits/conv0", 768, 128, 1)
    _spec(t, "AuxLogits/conv1", 128, 768, 5)
    _spec(t, "Mixed_7a/branch3x3_1", 768, 192, 1)
    _spec(t, "Mixed_7a/branch3x3_2", 192, 320, 3, stride=2)
    _spec(t, "Mixed_7a/branch7x7x3_1", 768, 192, 1)
    _spec(t, "Mixed_7a/branch7x7x3_2", 192, 192, (1, 7), pad=(0, 3))
    _spec(t, "Mixed_7a/branch7x7x3_3", 192, 192, (7, 1), pad=(3, 0))
    _spec(t, "Mixed_7a/branch7x7x3_4", 192, 192, 3, stride=2)
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        _spec(t, f"{name}/branch1x1", cin, 320, 1)
        _spec(t, f"{name}/branch3x3_1", cin, 384, 1)
        _spec(t, f"{name}/branch3x3_2a", 384, 384, (1, 3), pad=(0, 1))
        _spec(t, f"{name}/branch3x3_2b", 384, 384, (3, 1), pad=(1, 0))
        _spec(t, f"{name}/branch3x3dbl_1", cin, 448, 1)
        _spec(t, f"{name}/branch3x3dbl_2", 448, 384, 3, pad=1)
        _spec(t, f"{name}/branch3x3dbl_3a", 384, 384, (1, 3), pad=(0, 1))
        _spec(t, f"{name}/branch3x3dbl_3b", 384, 384, (3, 1), pad=(1, 0))
        _spec(t, f"{name}/branch_pool", cin, 192, 1)
    return t


CONVS = _conv_table()


def _shape_table():
    shapes = {}
    for name, (cin, cout, kh, kw, *_) in CONVS.items():
        shapes[f"{name}/conv/weight"] = (kh, kw, cin, cout)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}/bn/{leaf}"] = (cout,)
        shapes[f"{name}/bn/num_batches_tracked"] = ()
    shapes["AuxLogits/fc/weight"] = (1000, 768)
    shapes["AuxLogits/fc/bias"] = (1000,)
    shapes["fc/weight"] = (1000, 2048)
    shapes["fc/bias"] = (1000,)
    return shapes


# every key and shape of the converted npz (see the module docstring)
INCEPTION_SHAPES = _shape_table()


def random_inception_weights(seed=0):
    """Random weights in the npz layout, from `np.random.RandomState(seed)`
    in `INCEPTION_SHAPES` order: He-scaled convolutions and fc layers
    (std sqrt(2 / fan_in), fc sqrt(1 / fan_in)), zero biases, BatchNorm
    mean 0, variance 1, scale 1, shift 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, shape in INCEPTION_SHAPES.items():
        leaf = key.rsplit("/", 1)[1]
        if key.endswith("conv/weight"):
            std = np.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
            out[key] = (rng.standard_normal(shape) * std).astype(np.float32)
        elif key.endswith("fc/weight"):
            out[key] = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        elif leaf == "num_batches_tracked":
            out[key] = np.zeros(shape, np.int64)
        elif leaf in ("weight", "running_var"):
            out[key] = np.ones(shape, np.float32)
        else:
            out[key] = np.zeros(shape, np.float32)
    return out


def check_weights(data):
    """Raise ValueError unless `data` ({key: array}) has exactly the keys
    and shapes of `INCEPTION_SHAPES`."""
    missing = sorted(set(INCEPTION_SHAPES) - set(data))
    extra = sorted(set(data) - set(INCEPTION_SHAPES))
    wrong = sorted(k for k in set(data) & set(INCEPTION_SHAPES)
                   if tuple(np.shape(data[k])) != INCEPTION_SHAPES[k])
    if missing or extra or wrong:
        raise ValueError(
            "not an Inception-v3 npz of scripts/convert_inception.py: "
            f"missing {missing[:5]}{'...' if len(missing) > 5 else ''}, "
            f"unexpected {extra[:5]}{'...' if len(extra) > 5 else ''}, "
            "wrong shape " + ", ".join(
                f"{k} {tuple(np.shape(data[k]))} != {INCEPTION_SHAPES[k]}"
                for k in wrong[:5]))


class InceptionV3Features:
    """`features(images)` and `logits(images)` of torchvision's Inception-v3
    on the weights of `npz_path`, on `device` (default the card; raises
    without one)."""

    def __init__(self, npz_path, device="cuda"):
        self.device = resolve_device(device)
        with np.load(npz_path) as data:
            params = {k: data[k] for k in data.files}
        check_weights(params)

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
        self.convs = {}
        for name, (*_, stride, ph, pw) in CONVS.items():
            if name.startswith("AuxLogits"):
                continue
            bn = [tensor(params[f"{name}/bn/{leaf}"]) for leaf in
                  ("running_mean", "running_var", "weight", "bias")]
            # HWIO -> OIHW
            w = tensor(params[f"{name}/conv/weight"].transpose(3, 2, 0, 1))
            self.convs[name] = (w, stride, (ph, pw), bn)
        self.fc_weight = tensor(params["fc/weight"])       # [1000, 2048]
        self.fc_bias = tensor(params["fc/bias"])
        self.mean = torch.tensor(MEAN, device=self.device).reshape(1, 3, 1, 1)
        self.std = torch.tensor(STD, device=self.device).reshape(1, 3, 1, 1)

    def _conv_bn(self, name, x):
        w, stride, padding, (mean, var, gamma, beta) = self.convs[name]
        x = F.conv2d(x, w, stride=stride, padding=padding)
        return F.relu(F.batch_norm(x, mean, var, gamma, beta, training=False,
                                   eps=BN_EPS))

    def _branches(self, name, x, *chains):
        """Each chain of conv names run on `x` in turn, then concatenated;
        a chain that starts with "pool" runs the average pool first."""
        outs = []
        for chain in chains:
            y = x
            for step in chain:
                y = (F.avg_pool2d(y, 3, stride=1, padding=1, count_include_pad=False)
                     if step == "pool" else self._conv_bn(f"{name}/{step}", y))
            outs.append(y)
        return outs

    def _inception_a(self, name, x):
        return torch.cat(self._branches(
            name, x, ["branch1x1"], ["branch5x5_1", "branch5x5_2"],
            ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
            ["pool", "branch_pool"]), dim=1)

    def _inception_b(self, name, x):
        return torch.cat(self._branches(
            name, x, ["branch3x3"],
            ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"])
            + [F.max_pool2d(x, 3, stride=2)], dim=1)

    def _inception_c(self, name, x):
        return torch.cat(self._branches(
            name, x, ["branch1x1"], ["branch7x7_1", "branch7x7_2", "branch7x7_3"],
            [f"branch7x7dbl_{i}" for i in range(1, 6)], ["pool", "branch_pool"]),
            dim=1)

    def _inception_d(self, name, x):
        return torch.cat(self._branches(
            name, x, ["branch3x3_1", "branch3x3_2"],
            [f"branch7x7x3_{i}" for i in range(1, 5)])
            + [F.max_pool2d(x, 3, stride=2)], dim=1)

    def _inception_e(self, name, x):
        b1, b3, bd, bp = self._branches(
            name, x, ["branch1x1"], ["branch3x3_1"],
            ["branch3x3dbl_1", "branch3x3dbl_2"], ["pool", "branch_pool"])
        b3 = torch.cat([self._conv_bn(f"{name}/branch3x3_2a", b3),
                        self._conv_bn(f"{name}/branch3x3_2b", b3)], dim=1)
        bd = torch.cat([self._conv_bn(f"{name}/branch3x3dbl_3a", bd),
                        self._conv_bn(f"{name}/branch3x3dbl_3b", bd)], dim=1)
        return torch.cat([b1, b3, bd, bp], dim=1)

    @torch.no_grad()
    def _features(self, images):
        """`[N, H, W, 3]` uint8-range images -> `[N, 2048]` f32 tensor."""
        with precision.policy(False):
            x = resize_bilinear(images_to(images, self.device), 299, antialias=True)
            x = (x / 255.0 - self.mean) / self.std
            for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
                x = self._conv_bn(name, x)
            x = F.max_pool2d(x, 3, stride=2)
            x = self._conv_bn("Conv2d_3b_1x1", x)
            x = self._conv_bn("Conv2d_4a_3x3", x)
            x = F.max_pool2d(x, 3, stride=2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
                x = self._inception_a(name, x)
            x = self._inception_b("Mixed_6a", x)
            for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                x = self._inception_c(name, x)
            x = self._inception_d("Mixed_7a", x)
            x = self._inception_e("Mixed_7b", x)
            x = self._inception_e("Mixed_7c", x)
            return x.mean(dim=(2, 3))

    def __call__(self, images_uint8):
        """`[N, H, W, 3]` images in uint8 range -> `[N, 2048]` f32 numpy."""
        return self._features(images_uint8).cpu().numpy()

    @torch.no_grad()
    def logits(self, images_uint8):
        """Classifier logits `[N, 1000]` f32 numpy (for the Inception Score)."""
        feats = self._features(images_uint8)
        with precision.policy(False):
            return F.linear(feats, self.fc_weight, self.fc_bias).cpu().numpy()
