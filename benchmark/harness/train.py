"""Cells of traffic kind `train`: the program's training step, one unit of
work one step over a loader batch of `batch` real images, in a closed loop.

Set-up writes the cell's data under `TMPDIR` (seeded RGB images, masks of
`classes` smooth regions and orbit poses in `dataset.json`: the folder
dataset the loader reads), builds the run configuration with the training
CLI's own `run_config` from the configuration's `flags` (checked against
the configuration's `generator`, `discriminator` and `loss`), the networks
with `train/loop.build_training` (the loop's own seeded init), and the
loader and `StepInputs` as `training_loop` builds them.  Every step goes
through `train/loop.run_step`: the loader's next batch and the loop's
per-step draws, then `Trainer.step`.  Step indices run on from 0 as the
loop's do: `warmup_steps` steps (step 0 runs every phase, so each kernel is
built before the window), then the window's whole steps, then, if the
window ended before the last compared step, untimed steps up to it.  The
traced run profiles `trace_steps` more steps from the next index that is a
multiple of `trace_align`.

Before each compared step (`compare.steps`, indices inside any window) the
step's inputs are cloned on the device: the networks' states and Adam
moments, the batch, the latents and poses and the step generator's state;
after it, the state again and the stats.  After the window the program is
freed, and the plain reference (`reference/train_step.py`, f32, TF32 off)
steps from each clone.  Compared (each `<number>.max` over the steps and
`<number>.pooled` over them together):
- `loss`: each phase's loss stats (`Loss/G/*`, `Loss/D/*`,
  `Loss/r1_penalty*`; their means), relative error (`.max` the largest
  over the stats and steps);
- `reg`: the R1 phases' stats (penalty and loss of D and of D_semantic)
  in steps that run them, against the reference's R1 phase computed from
  the program's own network before that phase (its state after the step,
  the last update taken back, `reference.train_step.Adam.undo`): every
  phase before it has moved the two sides apart already, so this reads the
  R1 phase's own precision, and the regularization weight it applies;
- `mu.<net>`: the first Adam moment after the step, the gradient of the
  network's last phase (beta1 = 0), relative L2 over all its parameters;
- `delta.<net>`: the change of every parameter and buffer of G, D,
  D_semantic and G_ema over the step, relative L2.
A non-finite distance reads as infinity and fails.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import tempfile

import torch
import torch.nn.functional as F

from . import compare as gen_compare
from . import inputs, trace, window
from .generate import _merge
from .log import log

NETS = ("G", "D", "D_semantic")
STATE_NETS = NETS + ("G_ema",)
LOSS_PREFIXES = ("Loss/G/", "Loss/D/", "Loss/r1_penalty")
# the R1 phases' stats, each network's regularization (`reg`)
REG_PHASES = {"D": ("Loss/r1_penalty", "Loss/D/reg"),
              "D_semantic": ("Loss/r1_penalty_semantic", "Loss/D/reg_semantic")}
NUMBERS = (("loss", "reg") + tuple(f"mu.{k}" for k in NETS)
           + tuple(f"delta.{k}" for k in STATE_NETS))
D_REG_INTERVAL = 16     # `build_training`'s, which the CLI leaves as it is
# {step index: weight}: one average step of a long window, in which 1/4 of
# the steps run Greg and 1/16 Dreg too
STEP_MIX = {1: 1 - 1 / 4, 4: 1 / 4 - 1 / D_REG_INTERVAL, 16: 1 / D_REG_INTERVAL}


def loop_seed(seed):
    """The training loop's `random_seed` for a run's `--seed` (numpy's
    RandomState takes seeds below 2**32)."""
    return int(seed) % 2**32


# ------------------------------------------------------------------ data
def write_dataset(root, seed, data, camera):
    """`data["images"]` RGB images and 6-class masks at `data["resolution"]`²
    and their poses, drawn from `seed`, written as the port's folder
    dataset under `root`: (image folder, mask folder)."""
    from pix2pix3d_tpu_torch.utils.png import write_png
    n, res = data["images"], data["resolution"]
    gen = torch.Generator().manual_seed(int(seed))
    masks = inputs.label_pool(gen, n, res, data["classes"], "cpu", data["blobs"])
    low = torch.randn((n, 3, data["blobs"], data["blobs"]), generator=gen)
    rgb = torch.tanh(F.interpolate(low, size=(res, res), mode="bilinear",
                                   align_corners=False))
    rgb = ((rgb + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    t = torch.rand(n, generator=gen)
    poses = inputs.orbit_cameras(t, camera["radius"], camera["pivot"], camera["focal"])
    dirs = [os.path.join(root, "images"), os.path.join(root, "masks")]
    for d in dirs:
        os.makedirs(d)
    labels = []
    for i in range(n):
        name = f"img{i:05d}.png"
        write_png(os.path.join(dirs[0], name), rgb[i].numpy(), level=1)
        write_png(os.path.join(dirs[1], name), masks[i, ..., 0].to(torch.uint8).numpy(),
                  level=1)
        labels.append([name, [float(x) for x in poses[i]]])
    with open(os.path.join(dirs[0], "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    return dirs


def check_run_config(run_conf, conf):
    """Raise unless the CLI's run configuration is the one the
    configuration file states."""
    want = {"g_config": conf["generator"], "d_kwargs": conf["discriminator"]}
    for key, value in want.items():
        if run_conf[key] != value:
            raise ValueError(f"the CLI's {key} is not the configuration's: "
                             f"{run_conf[key]} != {value}")
    for key, value in conf["loss"].items():
        if run_conf["loss_kwargs"][key] != value:
            raise ValueError(f"the CLI's loss {key} {run_conf['loss_kwargs'][key]!r} "
                             f"is not the configuration's {value!r}")
    opt = conf["optim"]
    got = (run_conf["g_lr"], run_conf["d_lr"], run_conf["g_reg_interval"],
           run_conf["batch_size"])
    if got != (opt["g_lr"], opt["d_lr"], opt["g_reg_interval"], opt["batch"]):
        raise ValueError(f"the CLI's optimizer settings {got} are not the configuration's")


def _clone_state(trainer):
    """The networks' states and the optimizers' moments, cloned on the
    device: {net: state_dict}, {opt_<net>: {param name: {step, exp_avg,
    exp_avg_sq}}}."""
    out = {}
    for key, (module, opt) in trainer.networks().items():
        out[key] = {n: t.detach().clone() for n, t in module.state_dict().items()}
        if opt is None:
            continue
        moments = {}
        for name, p in module.named_parameters():
            st = opt.state.get(p)
            if st:
                moments[name] = {"step": float(st["step"]),
                                 "exp_avg": st["exp_avg"].clone(),
                                 "exp_avg_sq": st["exp_avg_sq"].clone()}
        out[f"opt_{key}"] = moments
    return out


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _fresh_moments(state):
    """A copy of the optimizer moments of `state` (the reference's Adam
    updates them in place)."""
    return {k: ({n: {"step": m["step"], "exp_avg": m["exp_avg"].clone(),
                     "exp_avg_sq": m["exp_avg_sq"].clone()} for n, m in v.items()}
                if k.startswith("opt_") else v)
            for k, v in state.items()}


class TrainWorst:
    """Every compared number over the compared steps, the numbers of
    `limits` held to them; `missing` counts the compared steps that never
    ran."""

    def __init__(self, limits, batch):
        self.limits = limits
        self.batch = batch
        self.max = {k: 0.0 for k in NUMBERS}
        self.sq = {k: [0.0, 0.0] for k in NUMBERS}
        self.answers = 0
        self.missing = 0
        self.stat_errors = {}     # each loss stat's largest relative error

    def _put(self, key, d2, r2):
        rel = math.sqrt(d2 / r2) if r2 > 0 else (0.0 if d2 == 0 else math.inf)
        rel = rel if math.isfinite(rel) else math.inf
        self.max[key] = max(self.max[key], rel)
        self.sq[key][0] += d2
        self.sq[key][1] += r2

    def add_step(self, got, want, before, got_reg=None, want_reg=None):
        """One compared step: `got` and `want` are {stats, state, mu} of the
        program (or the control) and of the reference, `before` the state
        both started from; `got_reg` and `want_reg` the R1 phases' stats
        ({name: [count, sum, sum of squares]}) of the step, if it ran them,
        and the reference's from the program's state before them."""
        for name in sorted(want_reg or {}):
            g, w = got_reg.get(name), want_reg[name]
            if g is None or g[0] != w[0]:
                self._put("reg", math.inf, 1.0)
                continue
            gm, wm = float(g[1]) / float(g[0]), float(w[1]) / float(w[0])
            self._put("reg", (gm - wm) ** 2, wm ** 2)
        names = sorted(k for k in want["stats"] if k.startswith(LOSS_PREFIXES))
        if names != sorted(k for k in got["stats"] if k.startswith(LOSS_PREFIXES)):
            self._put("loss", math.inf, 1.0)
        for name in names:
            g, w = got["stats"].get(name), want["stats"][name]
            if g is None or g[0] != w[0]:
                self._put("loss", math.inf, 1.0)
                continue
            gm, wm = float(g[1]) / float(g[0]), float(w[1]) / float(w[0])
            self._put("loss", (gm - wm) ** 2, wm ** 2)
            rel = abs(gm - wm) / abs(wm) if wm else math.inf
            self.stat_errors[name] = max(self.stat_errors.get(name, 0.0), rel)
        for key in NETS:
            self._put(f"mu.{key}", *_dist(got["mu"][key], want["mu"][key]))
        for key in STATE_NETS:
            self._put(f"delta.{key}", *_dist(got["state"][key], want["state"][key],
                                             before[key]))
        self.answers += self.batch

    @property
    def values(self):
        out = {}
        for k in NUMBERS:
            out[f"{k}.max"] = self.max[k]
            d2, r2 = self.sq[k]
            # nothing compared (no R1 phase in the steps) reads 0
            pooled = math.sqrt(d2 / r2) if r2 > 0 else (0.0 if d2 == 0 else math.inf)
            out[f"{k}.pooled"] = pooled if math.isfinite(pooled) else math.inf
        return out

    @property
    def correct(self):
        values = self.values
        return self.answers > 0 and not self.missing and all(
            math.isfinite(values[k]) and values[k] <= self.limits[k] for k in self.limits)

    @property
    def failed(self):
        """The compared steps' images when the run is not correct: the
        numbers pool the steps, so no single step is the one at fault."""
        return 0 if self.correct else self.answers + self.missing * self.batch

    def checks(self):
        values = self.values
        return {k: {"value": values[k], "limit": self.limits[k]} for k in self.limits}


def _dist(got, want, base=None):
    """(||got - want||², ||want - base||²) over the floating tensors of two
    {name: tensor} maps (base: None for 0), in float64."""
    d2 = r2 = 0.0
    for name, w in want.items():
        if not w.is_floating_point():
            continue
        g = got[name].to(w.device).double()
        w = w.double()
        ref = w if base is None else w - base[name].to(w.device).double()
        d = torch.nan_to_num(g - w, nan=math.inf, posinf=math.inf, neginf=math.inf)
        d2 += float(d.square().sum())
        r2 += float(ref.square().sum())
    return d2, r2


# ------------------------------------------------------------------ cell
class TrainCell:
    """One run's program side: `step()` runs the loop's next step (the
    device synchronized after it)."""

    def __init__(self, cell, seed, device, overrides=None):
        from pix2pix3d_tpu_torch.train import __main__ as cli
        from pix2pix3d_tpu_torch.train.dataset import DataLoader, build_dataset
        from pix2pix3d_tpu_torch.train.loop import StepInputs, build_training
        self.cell = cell
        self.conf = _merge(cell["config"], (overrides or {}).get("config"))
        self.traffic = _merge(cell["traffic"], (overrides or {}).get("traffic"))
        self.seed = int(seed)
        self.device = device
        t = self.traffic
        self.random_seed = loop_seed(seed)
        self.tmp = tempfile.mkdtemp(prefix="bench-train-")
        images, masks = write_dataset(self.tmp, seed, t["data"], self.conf["camera"])
        argv = (["--outdir", os.path.join(self.tmp, "runs"), "--data", images,
                 "--mask_data", masks, "--device", str(device),
                 "--seed", str(self.random_seed)] + self.conf["flags"])
        rc = self.run_conf = cli.run_config(cli.parser().parse_args(argv))
        if overrides is None:
            check_run_config(rc, self.conf)
        self.batch = rc["batch_size"]
        if self.batch != t["batch"] or t["unit_images"] != self.batch:
            raise ValueError(f"the CLI's batch {self.batch} is not the traffic's {t['batch']}")
        self.ema_kimg = self.batch * 10 / 32     # the loop's default
        self.dataset = build_dataset(**rc["dataset_kwargs"])
        self.label_dim = self.dataset.label_dim
        self.loader = DataLoader(self.dataset, batch_size=self.batch, seed=self.random_seed,
                                 rows=(0, self.batch), full_first=True)
        self.trainer = build_training(
            rc["g_config"], self.label_dim, d_kwargs=rc["d_kwargs"],
            loss_kwargs=rc["loss_kwargs"], use_d_semantic=rc["use_d_semantic"],
            augment_kwargs=rc["augment_kwargs"], lpips_weights=rc["lpips_weights"],
            g_lr=rc["g_lr"], d_lr=rc["d_lr"], g_reg_interval=rc["g_reg_interval"],
            random_seed=self.random_seed, device=device)
        next(self.loader)     # the loop's snapshot grid takes the first batch
        self.inputs = StepInputs(self.dataset, self.loader, self.batch, (0, self.batch),
                                 self.trainer.G.z_dim, self.random_seed, device)
        self.lpips_state = {n: v.clone() for n, v in
                            self.trainer.loss.lpips.state_dict().items()}
        self.compared = list(t["compare"]["steps"])
        self.snapshots = {}
        self.step_idx = 0

    def _step_fn(self, trainer, batch, gen_z, gen_c, generator, **kw):
        from pix2pix3d_tpu_torch.train.loop import Trainer
        k = kw["step_idx"]
        if k not in self.compared:
            return Trainer.step(trainer, batch, gen_z, gen_c, generator, **kw)
        snap = {"before": _clone_state(trainer),
                "inputs": ({n: v.clone() for n, v in batch.items()}, gen_z.clone(),
                           gen_c.clone(), generator.get_state())}
        stats = Trainer.step(trainer, batch, gen_z, gen_c, generator, **kw)
        after = _clone_state(trainer)
        snap["program"] = {"stats": stats, "state": {key: after[key] for key in STATE_NETS},
                           "mu": {key: {n: m["exp_avg"] for n, m in after[f"opt_{key}"].items()}
                                  for key in NETS},
                           "moments": {key: after[f"opt_{key}"] for key in REG_PHASES}}
        self.snapshots[k] = snap
        return stats

    def step(self, *_):
        from pix2pix3d_tpu_torch.train.loop import run_step
        k = self.step_idx
        run_step(self.trainer, self.inputs, self._step_fn, step_idx=k,
                 cur_nimg=k * self.batch, batch_size=self.batch, ema_kimg=self.ema_kimg,
                 ema_rampup=0.05, aug_p=self.run_conf["augment_p"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_idx += 1

    def free_program(self):
        """Free the program's networks, and move the compared steps'
        results to the host (the reference needs the card)."""
        for snap in self.snapshots.values():
            snap["program"] = _to_host(snap["program"])
        self.loader.close()
        self.dataset.close()
        del self.trainer, self.inputs, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)

    # --------------------------------------------------------- reference
    def reference(self):
        """The plain reference's networks and step at the run's configuration."""
        from reference import train_step as ref
        rc = self.run_conf
        nets = ref.build(rc["g_config"], rc["d_kwargs"], self.label_dim, self.device)
        step = ref.TrainStep(nets, rc["loss_kwargs"], g_lr=rc["g_lr"], d_lr=rc["d_lr"],
                             g_reg_interval=rc["g_reg_interval"])
        return nets, step

    def _reference_step(self, nets, step, k, snap, control=False):
        batch, gen_z, gen_c, gen_state = snap["inputs"]
        state = dict(_fresh_moments(snap["before"]), lpips=self.lpips_state)
        step.load(state)
        gen = torch.Generator(device=self.device)
        gen.set_state(gen_state)
        kw = dict(step_idx=k, cur_nimg=k * self.batch, batch_size=self.batch,
                  ema_kimg=self.ema_kimg, ema_rampup=0.05)
        if control:
            with ControlNets(nets):
                stats = step(batch, gen_z, gen_c, gen, **kw)
        else:
            with gen_compare.tf32(False):
                stats = step(batch, gen_z, gen_c, gen, **kw)
        return {"stats": {n: v.cpu().numpy() for n, v in stats.items()},
                "state": {key: {n: t.detach().clone() for n, t in nets[key].state_dict().items()}
                          for key in STATE_NETS},
                "mu": {key: {n: m["exp_avg"] for n, m in state[f"opt_{key}"].items()}
                       for key in NETS}}

    def _reg_probe(self, nets, step, k, snap, control=False):
        """The R1 phases of step `k` (none off their interval) by the
        reference, or the control, from the program's own networks before
        them: D's and D_semantic's last update of the step is their R1
        phase's, so their states after the step with that update taken
        back.  {stat name: [count, sum, sum of squares]} (numpy)."""
        from reference.train_step import Adam, blur_half_width
        if step.d_reg_interval is None or k % step.d_reg_interval or step.loss.r1_gamma <= 0:
            return {}
        batch = snap["inputs"][0]
        sigma = step.loss.blur_sigma(k * self.batch)
        half = blur_half_width(sigma)
        phases = {"D": step.loss.d_r1, "D_semantic": step.loss.d_semantic_r1}
        out = {}
        for key, phase in phases.items():
            after = {n: t.to(self.device) for n, t in snap["program"]["state"][key].items()}
            moments = {n: {"step": m["step"], "exp_avg": m["exp_avg"].to(self.device),
                           "exp_avg_sq": m["exp_avg_sq"].to(self.device)}
                       for n, m in snap["program"]["moments"][key].items()}
            lr, interval = step.opt_args[key]
            adam = Adam(nets[key], moments, lr, step.betas, step.eps, interval)
            params = {n: after[n] for n in adam.params}
            nets[key].load_state_dict(dict(after, **adam.undo(params, moments)), strict=True)
            with (ControlNets(nets) if control else gen_compare.tf32(False)):
                _, stats = phase(batch, sigma, half)
            out.update({n: v.cpu().numpy() for n, v in stats.items()})
        return out

    def compare(self, limits, sides=("program",)):
        """{side: TrainWorst} of the compared steps against the plain
        reference (f32, TF32 off): side "program" the program's steps,
        "control" the reference one precision below (`ControlNets`),
        "repeat" the reference once more (its own run-to-run spread)."""
        worst = {side: TrainWorst(limits, self.batch) for side in sides}
        nets, step = self.reference()
        for k in self.compared:
            snap = self.snapshots.get(k)
            if snap is None:
                for w in worst.values():
                    w.missing += 1
                continue
            want = self._reference_step(nets, step, k, snap)
            want_reg = self._reg_probe(nets, step, k, snap)
            for side, w in worst.items():
                if side == "program":
                    got = snap["program"]
                    got_reg = {n: got["stats"].get(n) for n in want_reg}
                else:
                    got = self._reference_step(nets, step, k, snap,
                                               control=side == "control")
                    got_reg = self._reg_probe(nets, step, k, snap, control=side == "control")
                w.add_step(got, want, snap["before"], got_reg, want_reg)
                del got
            del want
            if self.device.type == "cuda":
                log(f"step {k} compared; peak memory since the program was freed "
                    f"{torch.cuda.max_memory_allocated(self.device) / 2**30:.2f} GiB")
        del nets, step
        return worst

    def check(self, limits):
        """The program's compared steps against the plain reference."""
        return self.compare(limits)["program"]

    def flops_per_unit(self):
        """The reference's operations for one average window step (`STEP_MIX`),
        counted on `meta`, as the f32-peak-equivalent operations of
        `traffic["peak_flops"]`: those of the blocks the program runs in
        bf16 times f32_peak / bf16_peak."""
        from .counters import PEAK_FLOPS
        f32, bf16 = reference_step_flops(self, STEP_MIX)
        return f32 + bf16 * PEAK_FLOPS["f32"] / PEAK_FLOPS["bf16"]


def _key(t):
    return t.data_ptr(), tuple(t.shape), t.dtype


class _Fp8Blocks(gen_compare._Fp8Products):
    """`harness.compare`'s float8 products for the blocks the program runs
    in bf16: every product while such a block's forward runs (`depth` above
    0), and every later product (the convolutions' backward among them)
    that takes one of those products' operands, as the backward passes take
    the tensors their forward saved."""

    OPS = gen_compare._Fp8Products.OPS | {torch.ops.aten.convolution_backward.default}

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.operands = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            keys = {_key(a) for a in args if isinstance(a, torch.Tensor)}
            if self.depth > 0:
                self.operands |= keys
            if self.depth > 0 or keys & self.operands:
                args = tuple(gen_compare._fp8(a) for a in args)
        return func(*args, **(kwargs or {}))


class ControlNets:
    """The control's precision over every reference network: one step below
    the program's for each product.  The blocks the program runs in bf16
    (modules with `use_fp16`), forward and backward, take float8 products
    (`_Fp8Blocks`; their forward hooks raise its depth); every other f32
    product runs in TF32.  The mode is entered once around the step, so
    the autograd engine's threads run under it too."""

    def __init__(self, nets):
        self.nets = nets
        self.mode = _Fp8Blocks()
        self.handles = []

    def _enter(self, *_):
        self.mode.depth += 1

    def _leave(self, *_):
        self.mode.depth -= 1

    def __enter__(self):
        self.tf32 = gen_compare.tf32(True)
        self.tf32.__enter__()
        for net in self.nets.values():
            for m in net.modules():
                if getattr(m, "use_fp16", False):
                    self.handles += [m.register_forward_pre_hook(self._enter),
                                     m.register_forward_hook(self._leave)]
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for h in self.handles:
            h.remove()
        self.handles = []
        self.tf32.__exit__(*exc)


# ------------------------------------------------------------ operations
def _bf16_names(nets):
    """The names under which `FlopCounterMode` may count the blocks the
    program runs in bf16 tensors (modules with `use_fp16` set): its module
    tracker names a module by the class of the first module it saw run
    and the path from it, so every ancestor's class and path is a
    candidate."""
    names = set()
    for net in nets:
        for name, m in net.named_modules():
            if not getattr(m, "use_fp16", False):
                continue
            parts = name.split(".")
            for i in range(len(parts)):
                root = net.get_submodule(".".join(parts[:i]))
                names.add(".".join([type(root).__name__] + parts[i:]))
    return names


def reference_step_flops(run, mix):
    """(f32, bf16) floating-point operations of the reference's step,
    forward and backward, weighted by `mix` ({step index: weight}),
    counted by `torch.utils.flop_counter` on the `meta` device: products
    and convolutions only.  An operation counts as bf16 where the
    counter's module tracker places it in a block the program runs in
    bf16 (its forward and its backward); the R1 double backward's
    products, which the tracker places in no module, count as f32, so the
    least time is, if anything, overstated by their share at the slower
    peak."""
    from reference import train_step as ref
    from torch.utils.flop_counter import FlopCounterMode
    rc = run.run_conf
    with torch.device("meta"):
        nets = ref.build(rc["g_config"], rc["d_kwargs"], run.label_dim, "meta")
        step = ref.TrainStep(nets, rc["loss_kwargs"], g_lr=rc["g_lr"], d_lr=rc["d_lr"],
                             g_reg_interval=rc["g_reg_interval"])
    step.loss.remat = False      # the program computes each forward once
    res = rc["g_config"]["img_resolution"]
    b = run.batch
    meta = torch.device("meta")
    blocks = _bf16_names([nets[k] for k in NETS])
    totals = [0.0, 0.0]
    for k, weight in mix.items():
        state = {key: {n: torch.empty_like(t) for n, t in nets[key].state_dict().items()}
                 for key in STATE_NETS + ("lpips",)}
        for key in NETS:
            state[f"opt_{key}"] = {n: {"step": 1.0, "exp_avg": torch.empty_like(p),
                                       "exp_avg_sq": torch.empty_like(p)}
                                   for n, p in nets[key].named_parameters()}
        step.load(state)
        batch = {"image": torch.empty(b, res, res, 3, device=meta),
                 "mask": torch.zeros(b, res, res, 1, device=meta),
                 "pose": torch.empty(b, 25, device=meta)}
        gen = torch.Generator().manual_seed(0)
        counter = FlopCounterMode(display=False)
        with counter:
            step(batch, torch.empty(4, b, nets["G"].z_dim, device=meta),
                 torch.empty(4, b, 25, device=meta), gen, step_idx=k,
                 cur_nimg=k * b, batch_size=b, ema_kimg=run.ema_kimg)
        total = sum(counter.flop_counts["Global"].values())
        low = 0
        for name, ops in counter.get_flop_counts().items():
            if name in blocks:
                low += sum(ops.values())
        totals[0] += weight * (total - low)
        totals[1] += weight * low
    return totals[0], totals[1]


# ------------------------------------------------------------- measure
def measure(cell, seed, seconds, traced, device, overrides=None):
    """Set-up, window, optional trace, then the comparison; returns a dict
    the result line is built from."""
    from pix2pix3d_tpu_torch.ops import precision
    # a program without the loop's shared step path stops here, before set-up
    from pix2pix3d_tpu_torch.train.loop import StepInputs, run_step  # noqa: F401
    run = None
    try:
        with precision.policy(cell["traffic"]["tf32"]):
            run = TrainCell(cell, seed, device, overrides)
            t = run.traffic
            log(f"program built ({sum(p.numel() for p in run.trainer.G.parameters()):,} G "
                f"parameters), {t['data']['images']} images written and loaded")
            for _ in range(t["warmup_steps"]):
                run.step()
            log(f"{t['warmup_steps']} warm-up steps done; the window opens at step "
                f"{run.step_idx}")
            first = run.step_idx
            win = window.run(run.step, seconds)
            steps = range(first, first + win.units)
            greg = sum(k % run.run_conf["g_reg_interval"] == 0 for k in steps)
            dreg = sum(k % D_REG_INTERVAL == 0 for k in steps)
            lat = ", ".join(f"p{q} {win.percentile_ms(q):.3f}" for q in (0, 50, 100))
            log(f"window closed: steps {first}..{first + win.units - 1} ({win.units}) in "
                f"{win.seconds:.3f} s, {greg} with Greg, {dreg} with Dreg; step ms {lat}")
            out = {"window": win}
            while run.step_idx <= max(run.compared):
                run.step()
            if traced:
                while run.step_idx % t["trace_align"]:
                    run.step()
                at = run.step_idx
                out["trace"] = trace.record(run.step, t["trace_steps"], first=at)
                tr = out["trace"]
                log(f"traced steps {at}..{run.step_idx - 1}: busy {tr.busy_s:.6f} s of "
                    f"{tr.window_s:.6f} s")
            if device.type == "cuda":
                out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
                log(f"peak memory {out['memory_peak_bytes'] / 2**30:.2f} GiB")
            run.free_program()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            if traced:
                out["flops_per_unit"] = run.flops_per_unit()
                log(f"reference operations per step (f32-peak equivalent) "
                    f"{out['flops_per_unit']:.6e}")
            out["compare"] = run.check(cell["limits"]["numbers"])
            log(f"compared steps {run.compared} with the reference")
    finally:
        if run is not None:
            run.close()
    out["unit_images"] = run.batch
    return out
