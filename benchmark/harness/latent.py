"""Cells of traffic kind `latent`: a generator of images from latents alone
(StyleGAN3, `GeneratorS3`), one unit of work a batch of `batch` images, in a
closed loop.

Set-up builds the program's generator through the port's
`models.triplane.build_generator` from the configuration's `generator`
kwargs, draws its weights on the device from the seed (`weights.draw`, then
the Fourier input by its published init, `draw_input`), draws every unit's
z (a fresh z ~ N(0, I) for every image; c is empty, `c_dim` 0), and runs
`warmup_units` units (the first builds the program's CUDA kernels).  The
window then runs units back to back; the traced run profiles `trace_units`
more.  Then the program is freed and the plain reference
(`reference/nn/stylegan3.py`, f32, TF32 off) recomputes the images of the
units drawn from the seed among the first `compare.among`, in blocks of
`compare.block` images, from the same weights.

The comparison is `compare.Worst`'s rule on the one output `image`:
`image.max`, the largest relative L2 distance of one image, and
`image.pooled`, that of all compared images together.
"""

from __future__ import annotations

import copy
import gc
import math

import torch

from . import compare, counters, filtered_lrelu_work, trace, weights, window
from .generate import _merge, compared_units
from .log import log

OUTPUT = "image"
# the seed's streams besides the weights' (weights.draw seeds with the seed
# itself): the input's freqs and phases, and the latents
INPUT_STREAM = 0x5EED_F0
LATENT_STREAM = 0x5EED_2A


@torch.no_grad()
def draw_input(G, seed, device):
    """The Fourier input's published init (NVlabs/stylegan3
    `SynthesisInput.__init__`), drawn on `device` from the seed: freqs
    N(0, I2) divided by r * exp(r^2)^(1/4) and scaled by the bandwidth,
    phases U(-0.5, 0.5), the affine's weight 0 and bias [1, 0, 0, 0] (the
    identity transform).  Works on the program's and the reference's
    generator alike (the same names)."""
    inp = G.synthesis.input
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ INPUT_STREAM)
    freqs = torch.randn((inp.channels, 2), generator=gen, device=device)
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    inp.freqs.copy_(freqs / (radii * radii.square().exp().pow(0.25)) * inp.bandwidth)
    inp.phases.copy_(torch.rand(inp.channels, generator=gen, device=device) - 0.5)
    inp.affine.weight.zero_()
    inp.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))


def program_generator(gkw, seed, device):
    """The program's generator of `gkw`, built by the port's
    `build_generator`, weights drawn from `seed`."""
    from pix2pix3d_tpu_torch.models.triplane import build_generator
    kw = copy.deepcopy(gkw)
    G = build_generator(kw.pop("class_name"), device=device, **kw)
    weights.draw(G, seed, device)
    draw_input(G, seed, device)
    return G


def reference_generator(gkw, seed, device):
    from reference.nn.stylegan3 import GeneratorS3
    kw = copy.deepcopy(gkw)
    kw.pop("class_name")
    R = GeneratorS3(**kw).to(device).eval().requires_grad_(False)
    weights.draw(R, seed, device)
    draw_input(R, seed, device)
    return R


class ImageWorst:
    """`compare.Worst`'s numbers and verdict for the one output `image`:
    `image.max` and `image.pooled` over the answers added, the numbers in
    `limits` held to them; `failed` counts the images past an `image.max`
    limit, `missing` the compared units that never finished."""

    def __init__(self, limits):
        self.limits = limits
        self.max = 0.0
        self.sq = [0.0, 0.0]        # sums of squares: difference, reference
        self.answers = 0
        self.failed = 0
        self.missing = 0

    def add(self, got, want):
        """One block of images `[n, ...]` of the program and the reference."""
        n = want.shape[0]
        diff = (got.float() - want.float()).reshape(n, -1)
        ref = want.float().reshape(n, -1)
        d2, r2 = diff.square().sum(dim=1).double(), ref.square().sum(dim=1).double()
        rel = torch.nan_to_num((d2 / r2.clamp_min(1e-60)).sqrt(), nan=math.inf,
                               posinf=math.inf).cpu()
        self.max = max(self.max, float(rel.max()))
        self.sq[0] += float(d2.sum())
        self.sq[1] += float(r2.sum())
        limit = self.limits.get(f"{OUTPUT}.max")
        self.answers += n
        if limit is not None:
            self.failed += int((rel > limit).sum())

    @property
    def values(self):
        d2, r2 = self.sq
        pooled = math.sqrt(d2 / r2) if r2 > 0 else math.inf
        return {f"{OUTPUT}.max": self.max,
                f"{OUTPUT}.pooled": pooled if math.isfinite(pooled) else math.inf}

    @property
    def correct(self):
        values = self.values
        return self.answers > 0 and not self.missing and all(
            math.isfinite(values[k]) and values[k] <= self.limits[k] for k in self.limits)

    def checks(self):
        values = self.values
        return {k: {"value": values[k], "limit": self.limits[k]} for k in self.limits}


class LatentCell:
    """One run's program side: `unit(k)` runs unit k and returns its images
    (the device synchronized)."""

    def __init__(self, cell, seed, device, overrides=None):
        self.conf = _merge(cell["config"], (overrides or {}).get("config"))
        self.traffic = _merge(cell["traffic"], (overrides or {}).get("traffic"))
        self.seed = int(seed)
        self.device = device
        t = self.traffic
        self.gkw = copy.deepcopy(self.conf["generator"])
        self.batch = t["batch"]
        self.psi = t["truncation_psi"]
        self.G = program_generator(self.gkw, seed, device)
        gen = torch.Generator(device=device).manual_seed(self.seed ^ LATENT_STREAM)
        self.units = t["units"]
        self.z = torch.randn((self.units, self.batch, self.gkw["z_dim"]), generator=gen,
                             device=device)
        self.c = torch.zeros((self.batch, self.gkw["c_dim"]), device=device)
        self.keep = set(compared_units(seed, t["compare"]))
        self.kept = {}

    def latents(self, k):
        """Unit k's z; units past `units` repeat from the start."""
        return self.z[k % self.units]

    def unit(self, k):
        out = self.G(self.latents(k), self.c, truncation_psi=self.psi)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def keep_outputs(self, k, out):
        if k in self.keep:
            self.kept[k] = out

    def free_program(self):
        del self.G
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def flops_per_unit(self):
        """The reference's operations for one unit, counted on `meta`: its
        products and convolutions, but for the filtered lrelu's FIR filters
        (grouped convolutions over zero-inserted images, which count the
        zeros), whose polyphase operations (harness/filtered_lrelu_work.py)
        are added in their place."""
        R = filtered_lrelu_work.reference_on_meta(self.gkw)
        with torch.device("meta"):
            args = (torch.empty(self.batch, self.gkw["z_dim"]),
                    torch.empty(self.batch, self.gkw["c_dim"]))
        products = counters.reference_flops(R, args, exclude=("filtered_lrelu",))
        return products + filtered_lrelu_work.work(R.synthesis, self.batch)[1]

    def check(self, limits, program=None):
        """Compare the kept units' images with the plain reference's (f32,
        TF32 off); `program(z, c)`, if given, computes the images in the
        program's place (the control)."""
        worst = ImageWorst(limits)
        R = reference_generator(self.gkw, self.seed, self.device)
        block = self.traffic["compare"]["block"]
        with torch.no_grad(), compare.tf32(False):
            for k in sorted(self.keep):
                if program is None and k not in self.kept:
                    worst.missing += 1      # a compared unit that never finished
                    continue
                z = self.latents(k)
                for i in range(0, self.batch, block):
                    sl = slice(i, i + block)
                    want = R(z[sl], self.c[sl], truncation_psi=self.psi)
                    got = (program(z[sl], self.c[sl]) if program is not None
                           else self.kept[k][sl])
                    worst.add(got, want)
                    del want, got
        del R
        return worst


def measure(cell, seed, seconds, traced, device, overrides=None):
    """Set-up, window, optional trace, then the comparison; returns a dict
    the result line is built from."""
    from pix2pix3d_tpu_torch.ops import precision
    run = LatentCell(cell, seed, device, overrides)
    log("program built, weights and latents drawn")
    t = run.traffic
    out = {}
    with torch.no_grad(), precision.policy(t["tf32"]):
        for k in range(t["warmup_units"]):
            run.unit(run.units - 1 - k)
        log(f"{t['warmup_units']} warm-up units done; the window opens")
        win = window.run(run.unit, seconds, on_unit=run.keep_outputs)
        lat = ", ".join(f"p{q} {win.percentile_ms(q):.3f}" for q in (0, 50, 90, 95, 99, 100))
        log(f"window closed: {win.units} units in {win.seconds:.3f} s; latency ms {lat}")
        out["window"] = win
        if traced:
            out["trace"] = trace.record(run.unit, t["trace_units"], first=win.units)
            tr = out["trace"]
            log(f"traced {t['trace_units']} units: busy {tr.busy_s:.6f} s of "
                f"{tr.window_s:.6f} s")
            out["flops_per_unit"] = run.flops_per_unit()
            log(f"reference operations per unit {out['flops_per_unit']:.6e}")
        if device.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        run.free_program()
    out["compare"] = run.check(cell["limits"]["numbers"])
    log(f"compared {out['compare'].answers} answers with the reference")
    out["unit_images"] = run.batch
    out["gkw"] = run.gkw
    return out
