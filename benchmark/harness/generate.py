"""Cells of traffic kind `generate`: the program's generator forward, one
unit of work a batch of `batch` images (one request at batch 1), in a
closed loop.

Set-up builds the program's generator from the configuration's `generator`
kwargs and the traffic's path's overrides (`paths.<path>.generator`),
draws its weights on the device from the seed, draws every unit's inputs,
and runs `warmup_units` units (the first builds the program's CUDA
kernel where the path has one).  The window then runs units back to back.
After it, the traced run profiles `trace_units` more units.  Then the
program is freed and the plain reference recomputes the sampled units'
images (drawn from the seed among the first `compare.among` units, all of
which finish inside any window) in blocks of `compare.block` images.
"""

from __future__ import annotations

import copy
import gc
import random

import torch

from . import compare, counters, inputs, trace, weights, window
from .log import log


def _merge(base, over):
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def program_generator(gkw, seed, device):
    """The program's generator of `gkw`, weights drawn from `seed`."""
    from pix2pix3d_tpu_torch.models.triplane import GENERATOR_REGISTRY
    kw = copy.deepcopy(gkw)
    G = GENERATOR_REGISTRY[kw.pop("class_name").split(".")[-1]](**kw)
    G = G.to(device).eval().requires_grad_(False)
    weights.draw(G, seed, device)
    return G


def reference_generator(gkw, seed, device):
    from reference.generator import Generator
    R = Generator(**copy.deepcopy(gkw)).to(device).eval().requires_grad_(False)
    weights.draw(R, seed, device)
    return R


def compared_units(seed, spec):
    """Indices of the units whose images are compared, drawn from the seed."""
    rng = random.Random(int(seed) ^ 0x5EED)
    return sorted(rng.sample(range(spec["among"]), spec["units"]))


class GenerateCell:
    """One run's program side: `unit(k)` runs unit k and returns its
    outputs (the device synchronized)."""

    def __init__(self, cell, seed, device, overrides=None):
        self.cell = cell
        self.conf = _merge(cell["config"], (overrides or {}).get("config"))
        self.traffic = _merge(cell["traffic"], (overrides or {}).get("traffic"))
        self.seed = int(seed)
        self.device = device
        t = self.traffic
        path = self.conf["paths"][t["path"]]
        self.gkw = _merge(self.conf["generator"], path["generator"])
        self.batch = t["batch"]
        self.nrr = path["nrr"]
        self.G = program_generator(self.gkw, seed, device)
        data = dict(self.conf["data"], pool=t["pool"], phases=t["phases"])
        self.requests = inputs.Requests(seed, t["units"], self.batch, self.conf["camera"],
                                        data, self.gkw["z_dim"], device)
        self.keep = set(compared_units(seed, t["compare"]))
        self.kept = {}

    def unit(self, k):
        z, c, mask = self.requests.unit(k)
        out = self.G(z, c, {"mask": mask, "pose": c}, neural_rendering_resolution=self.nrr,
                     noise_mode="const", det=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def keep_outputs(self, k, out):
        if k in self.keep:
            self.kept[k] = {key: out[key] for key in compare.OUTPUTS}

    def free_program(self):
        del self.G
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def flops_per_unit(self):
        """The reference's operations for one unit, counted on `meta`."""
        from reference.generator import Generator
        with torch.device("meta"):
            R = Generator(**copy.deepcopy(self.gkw))
            res = self.conf["data"]["resolution"]
            args = (torch.empty(self.batch, self.gkw["z_dim"]),
                    torch.empty(self.batch, 25), torch.empty(self.batch, res, res, 1),
                    self.nrr)
        return counters.reference_flops(R, args)

    def check(self, limits, program=None):
        """Compare the kept units' images with the plain reference's (f32,
        TF32 off); `program`, if given, computes the images in the
        program's place (the control)."""
        worst = compare.Worst(limits)
        R = reference_generator(self.gkw, self.seed, self.device)
        block = self.traffic["compare"]["block"]
        with torch.no_grad(), compare.tf32(False):
            for k in sorted(self.keep):
                if program is None and k not in self.kept:
                    worst.missing += 1      # a compared unit that never finished
                    continue
                z, c, mask = self.requests.unit(k)
                for i in range(0, self.batch, block):
                    sl = slice(i, i + block)
                    want = R(z[sl], c[sl], mask[sl], self.nrr)
                    got = (program(z[sl], c[sl], mask[sl]) if program is not None
                           else {key: v[sl] for key, v in self.kept[k].items()})
                    worst.add(got, want)
                    del want, got
        del R
        return worst


def measure(cell, seed, seconds, traced, device, overrides=None):
    """Set-up, window, optional trace, then the comparison; returns a dict
    the result line is built from."""
    from pix2pix3d_tpu_torch.ops import precision
    run = GenerateCell(cell, seed, device, overrides)
    log("program built, weights and inputs drawn")
    t = run.traffic
    out = {}
    with torch.no_grad(), precision.policy(t["tf32"]):
        for k in range(t["warmup_units"]):
            run.unit(run.requests.units - 1 - k)
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
    out["gkw"], out["nrr"] = run.gkw, run.nrr
    return out
