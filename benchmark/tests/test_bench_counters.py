"""The operation and byte counters against hand counts at tiny shapes."""

import torch
from torch import nn

from harness import counters
from reference.generator import LateSeparateDecoder


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 16, bias=False)
        self.conv = nn.Conv2d(3, 5, 3, padding=1, bias=False)
        self.resample = Resample()

    def forward(self, x, img):
        return self.fc(x).sum() + self.conv(img).sum() + self.resample(img).sum()


class Resample(nn.Module):
    def forward(self, img):
        return torch.matmul(img, torch.ones(img.shape[-1], 7, device=img.device))


def test_products_are_counted_and_resampling_left_out():
    with torch.device("meta"):
        model = Toy()
        x, img = torch.empty(4, 8), torch.empty(2, 3, 6, 6)
    want = 2 * 4 * 8 * 16 + 2 * (2 * 5 * 6 * 6) * (3 * 3 * 3)
    assert counters.reference_flops(model, (x, img)) == want
    assert counters.reference_flops(model, (x, img), exclude=()) == want + 2 * 2 * 3 * 6 * 6 * 7


def test_decoder_operations_by_hand():
    dec = LateSeparateDecoder(32, {"decoder_output_dim": 32, "decoder_lr_mul": 1.0,
                                   "sigmoid": False})
    m = 10
    flops = counters.reference_flops(dec, (torch.zeros(1, 1, m, 32), torch.zeros(1, m, 3)))
    assert flops == 2 * m * 2 * (32 * 64 + 64 * 33)


def test_decode_composite_macs_are_the_packed_weights_live_entries():
    """The count of multiply-adds per sample is what the kernel's packed
    weights hold alive: W1t and W2t's two live blocks."""
    from pix2pix3d_tpu_torch.models.triplane import OSGDecoderSemanticLateSeparate
    from pix2pix3d_tpu_torch.ops.decode_composite import fuse_late_separate_params_t
    from harness import weights
    dec = OSGDecoderSemanticLateSeparate(32, {"decoder_output_dim": 32,
                                              "decoder_lr_mul": 1.0, "sigmoid": False})
    weights.draw(dec, 3, torch.device("cpu"))
    w1t, b1, w2t, b2 = fuse_late_separate_params_t(dec, 1.0)
    assert int((w1t != 0).sum()) + int((w2t[:65] != 0).sum()) == counters.DECODE_MACS


def test_decode_composite_bytes_by_hand():
    n, t, r = 2, 16, 64
    n_bytes, flops = counters.decode_composite_work(n, t, r, 2)
    feats = t * n * 32 * r * 2
    small = n * t * 4 + n * r * 4 + (128 * 32 + 128 + 128 * 128 + 128) * 4
    out = n * r * (64 + 1 + 1) * 4
    assert n_bytes == feats + small + out
    assert flops == 2 * n * t * r * (32 * 128 + 64 * 32 + 64 * 33)
    assert counters.bound_s(n_bytes, flops, 1.0) == flops


def test_bound_picks_the_slower_of_memory_and_operations():
    assert counters.bound_s(3.35e12, 1.0, 1e12) == 1.0
    assert counters.bound_s(1.0, 2e12, 1e12) == 2.0
