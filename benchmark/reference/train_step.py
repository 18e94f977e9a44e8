"""One training step of the pix2pix3D seg recipe, plain: the benchmark's
reference for cells of traffic kind `train`, f32 throughout (the caller
keeps TF32 off for products and convolutions).

The step is the program's one-card `Trainer.step` with one accumulation
round, written out: the two no-grad renders of the cross-view term, Gmain,
Greg (every `g_reg_interval` steps), Dmain and the w_avg update, Dreg
(every `d_reg_interval` steps), D_semantic main and reg, then the generator
EMA.  Each phase's loss is differentiated with respect to its own network
only (the others' parameters take no gradient), a parameter the phase does
not reach gets a zero gradient, the gradient is multiplied by the phase's
gain (the interval for the reg phases) and goes through
`nan_to_num(nan=0, posinf=1e5, neginf=-1e5)`, and the network takes one
Adam step, written out here, with the lazy-regularization scaling of the
learning rate and betas (r = I / (I + 1)).

Randomness: every draw comes from the one `torch.Generator` handed in (a
copy of the program's step generator's state), in the program's order and
with its shapes: per phase the pose coin (U[0, 1) scalar), then per
generator forward the backbone's noise (noise_mode 'random', one N(0, 1)
draw per noisy layer), the stratified depths' jitter and the importance
pass's U[0, 1) (det=False); the density regularization draws its
perturbation, then per point set the points and the directions, then the
backbone's noise.  The SR stacks draw nothing (`superresolution_noise_mode`
'none') and the discriminators nothing (`disc_c_noise` 0); the reference
raises where a setting would draw elsewhere.

Departures from the published `training/loss.py` (ref), which the program
shares and the reference therefore keeps:
- the blur's kernel half width is floor(3 sigma) rounded up to a multiple
  of 8, the extra taps carrying the true Gaussian weights (the JAX
  trainer's bucket; ref: floor(3 sigma));
- the reg phases multiply the gradient by the interval, where the
  published code multiplies the loss (the same number up to rounding);
- every gradient goes through `nan_to_num`, as the JAX trainer's does
  (ref: the same, in `training_loop.py:380-383`, on the flat gradient);
- the cross-view term's two renders run before Gmain, in no-grad, with
  their own draws (ref: inside Gmain);
- the draws come from one explicit generator (ref: the global RNG);
- LPIPS is a random VGG16 (the program's `train/lpips.py` fallback: the
  tree holds no published LPIPS weights), its weights taken from the
  program's module;
- the reconstruction terms at full resolution are computed and multiplied
  by 0 under `only_raw_recons`, as the program computes them.

Memory: the reference holds every block in f32 where the program holds
D's and the SR stacks' highest resolutions in bf16, so G's forwards with
gradients run under activation checkpointing (`RecipeLoss.run_G`, as the
program's `remat` option does it): the backward recomputes them, drawing
the same numbers again, and the step fits one card at batch 4.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .generator import Generator
from .lpips import LPIPS
from .nn.discriminator import DualDiscriminator, filtered_resizing
from .ops.bias_act import softplus
from .ops.upfirdn2d import filter2d, setup_filter
from .render.ray_sampler import sample_rays

NETS = ("G", "D", "D_semantic")
GAN_NETS = NETS + ("G_ema",)
EMA_COPIED = ("w_avg", "noise_const")     # copied into G_ema, not averaged


def draw_uniform(generator, shape, device):
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def draw_normal(generator, shape, device):
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def moments(value):
    """[count, sum, sum of squares] of a tensor, f32, as the program's stats."""
    v = value.detach().float()
    return torch.stack([torch.full((), float(v.numel()), device=v.device),
                        v.sum(), v.square().sum()])


class Stats(dict):
    def report(self, name, value):
        m = moments(value)
        self[name] = self[name] + m if name in self else m


class TrainGenerator(Generator):
    """The reference generator with its training forward: the backbone's
    random noise, the importance renderer's jitter, and the field at
    points (density regularization)."""

    def mapping(self, z, c, batch):
        return self.backbone.mapping(z, self._pose_c(c), batch=batch)

    def planes(self, ws, generator):
        img = self.backbone.synthesis(ws, noise_mode="random", generator=generator)
        n, _, h, w = img.shape
        return img.reshape(n, 3, 32, h, w).permute(0, 1, 3, 4, 2)

    def synthesis(self, ws, c, nrr, generator):
        rk = self.rendering_kwargs
        if rk.get("sampler") == "frustum" or rk.get("density_noise", 0) > 0:
            raise ValueError("the reference trains through the importance renderer "
                             "without density noise")
        planes = self.planes(ws, generator)
        cam2world, intrinsics = c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3)
        ray_origins, ray_directions = sample_rays(cam2world, intrinsics, nrr)
        feats, depths, _ = self.renderer(planes, self.decoder, ray_origins, ray_directions,
                                         rk, generator=generator, det=False)
        n = ws.shape[0]
        fimg = feats.reshape(n, nrr, nrr, -1).permute(0, 3, 1, 2)
        half = fimg.shape[1] // 2
        rgb_feats, sem_feats = fimg[:, :half], fimg[:, half:]
        rgb, sem = rgb_feats[:, :3], sem_feats[:, :self.semantic_channels]
        mode = rk["superresolution_noise_mode"]
        if mode == "random":
            raise ValueError("the reference holds SR stacks that draw no noise")
        sr_image = self.superresolution(rgb, rgb_feats, ws, noise_mode=mode)
        sr_sem = self.superresolution_semantic(sem, sem_feats, ws, noise_mode=mode)
        return {"image": nhwc(sr_image), "image_raw": nhwc(rgb),
                "image_depth": depths.reshape(-1, nrr, nrr, 1),
                "semantic": nhwc(sr_sem), "semantic_raw": nhwc(sem)}

    def sample_mixed(self, coords, dirs, ws, generator):
        planes = self.planes(ws, generator)
        return self.renderer.run_model(planes, self.decoder, coords, dirs,
                                       self.rendering_kwargs)


def smooth_l1(x, y):
    return F.smooth_l1_loss(x, y, beta=1.0)


def cross_entropy2d(logits_nhwc, target_hw):
    logp = torch.log_softmax(logits_nhwc, dim=-1)
    return -torch.gather(logp, -1, target_hw.long()[..., None])[..., 0].mean()


def nearest_resize(x, size):
    """NHWC nearest-neighbour resize (F.interpolate mode 'nearest')."""
    h = x.shape[1]
    if h == size:
        return x
    idx = (torch.arange(size, dtype=torch.float32) * (h / size)).long().to(x.device)
    return x[:, idx][:, :, idx]


def blur_half_width(sigma):
    """floor(3 sigma) rounded up to a multiple of 8, or 0."""
    size = int(math.floor(sigma * 3))
    return -(-size // 8) * 8 if size > 0 else 0


def blur(image, sigma, half_width):
    """Gaussian blur of an NCHW image over 2 * half_width + 1 taps."""
    if half_width <= 0:
        return image
    taps = torch.arange(-half_width, half_width + 1, dtype=torch.float32,
                        device=image.device)
    f = torch.exp2(-(taps / torch.tensor(float(sigma), dtype=torch.float32)).square())
    return filter2d(image, f / f.sum())


class RecipeLoss:
    """The phases' losses of the seg recipe over (G, D, D_semantic, LPIPS),
    with the loss kwargs of the program's run configuration."""

    SUPPORTED_OFF = ("silhouette_loss", "remat", "seg_weight", "raw_fade_kimg",
                     "neural_rendering_resolution_final", "style_mixing_prob")

    def __init__(self, G, D, D_semantic, lpips, *, r1_gamma, blur_init_sigma,
                 blur_fade_kimg, neural_rendering_resolution_initial, random_c_prob,
                 lambda_l1, lambda_lpips, lambda_D_semantic, only_raw_recons,
                 lambda_cross_view, dual_discrimination=True, filter_mode="antialiased",
                 **other):
        for key in self.SUPPORTED_OFF:
            if other.get(key):
                raise ValueError(f"the reference does not hold {key}={other[key]!r}")
        if G.data_type != "seg" or not dual_discrimination:
            raise ValueError("the reference holds the seg recipe with dual discrimination")
        self.G, self.D, self.D_semantic, self.lpips = G, D, D_semantic, lpips
        self.r1_gamma = r1_gamma
        self.blur_init_sigma = blur_init_sigma
        self.blur_fade_kimg = blur_fade_kimg
        self.nrr = neural_rendering_resolution_initial
        self.random_c_prob = random_c_prob
        self.lambda_l1 = lambda_l1
        self.lambda_lpips = lambda_lpips
        self.lambda_D_semantic = lambda_D_semantic
        self.only_raw = float(only_raw_recons)
        self.lambda_cross_view = lambda_cross_view
        self.filter_mode = filter_mode
        self.resample_filter = setup_filter([1, 3, 3, 1])
        self.remat = True

    def blur_sigma(self, cur_nimg):
        if self.blur_fade_kimg <= 0:
            return 0.0
        return float(max(1 - cur_nimg / (self.blur_fade_kimg * 1e3), 0) * self.blur_init_sigma)

    # ------------------------------------------------------------- pieces
    def _run_G(self, z, batch, c_render, generator):
        ws = self.G.mapping(z, batch["pose"], batch)
        return self.G.synthesis(ws, c_render, self.nrr, generator), ws

    def run_G(self, z, batch, c_render, generator):
        """G's forward; with gradients and `remat` (the default), recomputed
        in the backward pass
        (activation checkpointing) from a copy of the generator as it
        stood before the forward, so the recompute draws the forward's
        numbers again: the same values in less memory."""
        if not (self.remat and torch.is_grad_enabled()):
            return self._run_G(z, batch, c_render, generator)
        state = generator.get_state()
        runs = []

        def run(z, batch, c_render):
            g = generator
            if runs:
                g = torch.Generator(device=generator.device)
                g.set_state(state)
            runs.append(g)
            return self._run_G(z, batch, c_render, g)
        return checkpoint(run, z, batch, c_render, use_reentrant=False)

    def run_net(self, net, img, c, sigma, half, generator=None):
        image = blur(nchw(img["image"]), sigma, half)
        return net({"image": image, "image_raw": nchw(img["image_raw"])}, c,
                   generator=generator)

    def resize(self, x_nhwc, size):
        return nhwc(filtered_resizing(nchw(x_nhwc), size, f=self.resample_filter,
                                      filter_mode=self.filter_mode))

    def real_pair(self, batch, sigma, half):
        raw = self.resize(batch["image"], self.nrr)
        return {"image": batch["image"], "image_raw": nhwc(blur(nchw(raw), sigma, half))}

    def real_semantic_pair(self, batch, sigma, half):
        real = self.real_pair(batch, sigma, half)
        mask = F.one_hot(batch["mask"][..., 0].long(), self.G.semantic_channels).float()
        return {"image": torch.cat([real["image"], mask], dim=-1),
                "image_raw": torch.cat([real["image_raw"], self.resize(mask, self.nrr)],
                                       dim=-1)}

    @staticmethod
    def semantic_concat(gen_img, detach_rgb):
        image, image_raw = gen_img["image"], gen_img["image_raw"]
        if detach_rgb:
            image, image_raw = image.detach(), image_raw.detach()
        return {"image": torch.cat([image, torch.softmax(gen_img["semantic"], -1)], -1),
                "image_raw": torch.cat([image_raw,
                                        torch.softmax(gen_img["semantic_raw"], -1)], -1)}

    def coin(self, generator, device):
        if self.random_c_prob <= 0:
            return torch.zeros((), device=device)
        return (draw_uniform(generator, (), device) < self.random_c_prob).float()

    def lpips_mean(self, a, b):
        return self.lpips(nchw(a), nchw(b)).mean()

    def r1(self, net, pair, c, sigma, half):
        image = pair["image"].detach().requires_grad_(True)
        image_raw = pair["image_raw"].detach().requires_grad_(True)
        out = self.run_net(net, {"image": image, "image_raw": image_raw}, c, sigma, half)
        g_img, g_raw = torch.autograd.grad(out.sum(), [image, image_raw], create_graph=True)
        return g_img.square().sum(dim=(1, 2, 3)) + g_raw.square().sum(dim=(1, 2, 3))

    # ------------------------------------------------------------- phases
    @torch.no_grad()
    def cross_view_prep(self, z, batch, gen_c, generator):
        gi_rc, _ = self.run_G(z, batch, gen_c, generator)
        proj_mask = gi_rc["semantic"].argmax(dim=-1, keepdim=True).float()
        gi_rec, _ = self.run_G(z, batch, batch["pose"], generator)
        return {"proj_mask": proj_mask.contiguous(),
                "recon_sem_raw": gi_rec["semantic_raw"].contiguous()}

    def g_main(self, batch, z, gen_c, generator, sigma, half, cv_aux):
        stats = Stats()
        pose = batch["pose"]
        coin = self.coin(generator, pose.device)
        c_render = torch.where(coin > 0, gen_c, pose)
        recon_on = 1.0 - coin
        gen_img, _ = self.run_G(z, batch, c_render, generator)
        logits = self.run_net(self.D, gen_img, c_render, sigma, half, generator)
        stats.report("Loss/scores/fake", logits)
        stats.report("Loss/signs/fake", torch.sign(logits))
        loss = softplus(-logits).mean()
        logits_sem = self.run_net(self.D_semantic, self.semantic_concat(gen_img, True),
                                  c_render, sigma, half)
        stats.report("Loss/scores/fake_semantic", logits_sem)
        loss = loss + softplus(-logits_sem).mean() * self.lambda_D_semantic

        real = self.real_pair(batch, 0.0, 0)
        rec_full = (smooth_l1(gen_img["image"], real["image"]) * self.lambda_l1
                    + self.lpips_mean(gen_img["image"], real["image"]) * self.lambda_lpips)
        rec_raw = (smooth_l1(gen_img["image_raw"], real["image_raw"]) * self.lambda_l1
                   + self.lpips_mean(gen_img["image_raw"], real["image_raw"])
                   * self.lambda_lpips)
        rec = rec_full * (1 - self.only_raw) + rec_raw
        stats.report("Loss/G/loss_img_reconstruction", rec)
        loss = loss + rec * recon_on

        mask = batch["mask"]
        mask_raw = nearest_resize(mask, self.nrr)
        sem_rec = (cross_entropy2d(gen_img["semantic"], mask[..., 0]) * (1 - self.only_raw)
                   + cross_entropy2d(gen_img["semantic_raw"], mask_raw[..., 0]))
        stats.report("Loss/G/loss_semantic_reconstruction", sem_rec)
        loss = loss + sem_rec * recon_on

        if self.lambda_cross_view > 0:
            batch_proj = dict(batch, mask=cv_aux["proj_mask"])
            gen_proj, _ = self.run_G(z, batch_proj, pose, generator)
            cv = smooth_l1(gen_proj["semantic_raw"], cv_aux["recon_sem_raw"]) \
                * self.lambda_cross_view
            stats.report("Loss/G/loss_cross_view", cv)
            loss = loss + cv
        stats.report("Loss/G/loss", loss)
        return loss, stats

    def g_reg(self, batch, z, generator):
        rk = self.G.rendering_kwargs
        dev = batch["pose"].device
        if rk.get("density_reg", 0) == 0:
            return torch.zeros((), device=dev), Stats()
        if rk.get("reg_type", "l1") != "l1":
            raise ValueError("the reference holds density regularization 'l1' only")
        ws = self.G.mapping(z, batch["pose"], batch)
        n = ws.shape[0]
        pert = draw_normal(generator, (n, 1000, 3), dev) * rk["density_reg_p_dist"]
        initial = draw_uniform(generator, (n, 1000, 3), dev) * 2 - 1
        coords = torch.cat([initial, initial + pert], dim=1)
        dirs = draw_normal(generator, coords.shape, dev)
        sigma = self.G.sample_mixed(coords, dirs, ws, generator)["sigma"]
        loss = (sigma[:, :1000] - sigma[:, 1000:]).abs().mean() * rk["density_reg"]
        return loss, Stats()

    def d_main(self, batch, z, gen_c, generator, sigma, half):
        stats = Stats()
        pose = batch["pose"]
        coin = self.coin(generator, pose.device)
        c_render = torch.where(coin > 0, gen_c, pose)
        with torch.no_grad():
            gen_img, ws = self.run_G(z, batch, c_render, generator)
        logits = self.run_net(self.D, gen_img, c_render, sigma, half, generator)
        stats.report("Loss/scores/fake", logits)
        stats.report("Loss/signs/fake", torch.sign(logits))
        loss_gen = softplus(logits).mean()
        real_logits = self.run_net(self.D, self.real_pair(batch, sigma, half), pose, sigma,
                                   half, generator)
        stats.report("Loss/scores/real", real_logits)
        stats.report("Loss/signs/real", torch.sign(real_logits))
        loss_real = softplus(-real_logits).mean()
        stats.report("Loss/D/loss", loss_gen + loss_real)
        return loss_gen + loss_real, stats, ws

    def d_r1(self, batch, sigma, half):
        stats = Stats()
        penalty = self.r1(self.D, self.real_pair(batch, sigma, half), batch["pose"],
                          sigma, half)
        loss = penalty.mean() * (self.r1_gamma / 2)
        stats.report("Loss/r1_penalty", penalty)
        stats.report("Loss/D/reg", loss)
        return loss, stats

    def d_semantic_main(self, batch, z, gen_c, generator, sigma, half):
        stats = Stats()
        pose = batch["pose"]
        coin = self.coin(generator, pose.device)
        c_render = torch.where(coin > 0, gen_c, pose)
        with torch.no_grad():
            gen_img, _ = self.run_G(z, batch, c_render, generator)
        logits = self.run_net(self.D_semantic, self.semantic_concat(gen_img, False),
                              c_render, sigma, half)
        stats.report("Loss/scores/fake_semantic", logits)
        loss_gen = softplus(logits).mean()
        real_logits = self.run_net(self.D_semantic, self.real_semantic_pair(batch, sigma, half),
                                   pose, sigma, half)
        stats.report("Loss/scores/real_semantic", real_logits)
        loss_real = softplus(-real_logits).mean()
        stats.report("Loss/D/loss_semantic", loss_gen + loss_real)
        return loss_gen + loss_real, stats

    def d_semantic_r1(self, batch, sigma, half):
        stats = Stats()
        penalty = self.r1(self.D_semantic, self.real_semantic_pair(batch, sigma, half),
                          batch["pose"], sigma, half)
        loss = penalty.mean() * self.r1_gamma * 0.5
        stats.report("Loss/r1_penalty_semantic", penalty)
        stats.report("Loss/D/reg_semantic", loss)
        return loss, stats


class Adam:
    """`torch.optim.Adam`'s update, written out, over a network's named
    parameters, with the lazy-regularization scaling.  `state` maps a
    parameter's name to {step, exp_avg, exp_avg_sq} (the program's
    optimizer state, updated in place)."""

    def __init__(self, module, state, lr, betas=(0.0, 0.99), eps=1e-8, reg_interval=None):
        r = 1.0 if reg_interval is None else reg_interval / (reg_interval + 1)
        self.params = dict(module.named_parameters())
        self.state = state
        self.lr = lr * r
        self.b1, self.b2 = betas[0] ** r, betas[1] ** r
        self.eps = eps

    @torch.no_grad()
    def step(self, grads):
        for name, p in self.params.items():
            g = grads[name]
            st = self.state.get(name)
            if st is None:
                st = self.state[name] = {"step": 0.0, "exp_avg": torch.zeros_like(p),
                                         "exp_avg_sq": torch.zeros_like(p)}
            st["step"] = float(st["step"]) + 1
            st["exp_avg"].lerp_(g, 1 - self.b1)
            st["exp_avg_sq"].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            bc1 = 1 - self.b1 ** st["step"]
            bc2_sqrt = (1 - self.b2 ** st["step"]) ** 0.5
            denom = (st["exp_avg_sq"].sqrt() / bc2_sqrt).add_(self.eps)
            p.addcdiv_(st["exp_avg"], denom, value=-self.lr / bc1)

    @torch.no_grad()
    def undo(self, params, state):
        """The parameters before the last step, from `params` ({name:
        tensor}) and `state` (the moments and count) after it: the update
        added back (exact up to one rounding of each parameter)."""
        out = {}
        for name, p in params.items():
            st = state[name]
            bc1 = 1 - self.b1 ** st["step"]
            bc2_sqrt = (1 - self.b2 ** st["step"]) ** 0.5
            denom = (st["exp_avg_sq"].sqrt() / bc2_sqrt).add_(self.eps)
            out[name] = p.addcdiv(st["exp_avg"], denom, value=self.lr / bc1)
        return out


def build(g_config, d_kwargs, label_dim, device):
    """The reference's networks at the program's configuration, f32:
    {G, D, D_semantic, G_ema, lpips} (weights unset)."""
    gkw = dict(g_config)
    gkw.setdefault("c_dim", label_dim)
    d_common = dict(c_dim=label_dim, img_resolution=gkw["img_resolution"], **d_kwargs)
    nets = {"G": TrainGenerator(**gkw),
            "D": DualDiscriminator(img_channels=3, **d_common),
            "D_semantic": DualDiscriminator(img_channels=3 + gkw["semantic_channels"],
                                            **d_common),
            "G_ema": TrainGenerator(**gkw),
            "lpips": LPIPS()}
    return {k: v.to(device).requires_grad_(False) for k, v in nets.items()}


class TrainStep:
    """The reference step over `nets` (`build`'s) with the run
    configuration's loss kwargs, learning rates and reg intervals."""

    def __init__(self, nets, loss_kwargs, g_lr=0.0025, d_lr=0.002, g_reg_interval=4,
                 d_reg_interval=16, betas=(0.0, 0.99), eps=1e-8):
        self.nets = nets
        self.loss = RecipeLoss(nets["G"], nets["D"], nets["D_semantic"], nets["lpips"],
                               **loss_kwargs)
        self.opt_args = {"G": (g_lr, g_reg_interval), "D": (d_lr, d_reg_interval),
                         "D_semantic": (d_lr, d_reg_interval)}
        self.g_reg_interval = g_reg_interval
        self.d_reg_interval = d_reg_interval
        self.betas, self.eps = betas, eps

    def load(self, state):
        """Take the program's state before the step: {net: state_dict} for
        the four networks and lpips, {opt_<net>: {name: {step, exp_avg,
        exp_avg_sq}}} (used in place)."""
        with torch.no_grad():
            for key in GAN_NETS + ("lpips",):
                self.nets[key].load_state_dict(state[key], strict=True)
        self.opts = {k: Adam(self.nets[k], state[f"opt_{k}"], lr, self.betas, self.eps, i)
                     for k, (lr, i) in self.opt_args.items()}

    def _trainable(self, active):
        for k in NETS:
            self.nets[k].requires_grad_(k == active)

    def _phase(self, key, fn, gain):
        """`fn()` -> (loss, stats, ...) with only `key`'s parameters taking
        gradients; its gradient x gain -> nan_to_num -> one Adam step.
        Returns what `fn` returned after the loss."""
        self._trainable(key)
        value, *rest = fn()
        params = self.opts[key].params
        names = list(params)
        grads = (torch.autograd.grad(value, [params[n] for n in names], allow_unused=True)
                 if value.requires_grad else [None] * len(names))
        grads = {n: torch.nan_to_num((torch.zeros_like(params[n]) if g is None else g)
                                     * gain, nan=0.0, posinf=1e5, neginf=-1e5)
                 for n, g in zip(names, grads)}
        del value
        self.opts[key].step(grads)
        self._trainable(None)
        return rest

    def __call__(self, batch, gen_z, gen_c, generator, *, step_idx, cur_nimg, batch_size,
                 ema_kimg, ema_rampup=0.05):
        """One step; returns {stat name: [count, sum, sum of squares]} (f32
        tensors on the networks' device)."""
        loss, G = self.loss, self.nets["G"]
        sigma = loss.blur_sigma(cur_nimg)
        half = blur_half_width(sigma)
        stats = Stats()

        def add(s):
            for k, v in s.items():
                stats[k] = stats[k] + v if k in stats else v

        cv_aux = None
        if loss.lambda_cross_view > 0:
            cv_aux = loss.cross_view_prep(gen_z[0], batch, gen_c[0], generator)
        add(*self._phase("G", lambda: loss.g_main(batch, gen_z[0], gen_c[0], generator,
                                                   sigma, half, cv_aux), 1.0))
        if self.g_reg_interval is not None and step_idx % self.g_reg_interval == 0:
            add(*self._phase("G", lambda: loss.g_reg(batch, gen_z[1], generator),
                             float(self.g_reg_interval)))
        do_dreg = (self.d_reg_interval is not None and step_idx % self.d_reg_interval == 0
                   and loss.r1_gamma > 0)
        s, ws = self._phase("D", lambda: loss.d_main(batch, gen_z[2], gen_c[2], generator,
                                                     sigma, half), 1.0)
        with torch.no_grad():
            mapping = G.backbone.mapping
            ws_mean = ws.mean(dim=0)
            mapping.w_avg.copy_(ws_mean + mapping.w_avg_beta * (mapping.w_avg - ws_mean))
        add(s)
        if do_dreg:
            add(*self._phase("D", lambda: loss.d_r1(batch, sigma, half),
                             float(self.d_reg_interval)))
        add(*self._phase("D_semantic", lambda: loss.d_semantic_main(
            batch, gen_z[3], gen_c[3], generator, sigma, half), 1.0))
        if do_dreg:
            add(*self._phase("D_semantic", lambda: loss.d_semantic_r1(batch, sigma, half),
                             float(self.d_reg_interval)))

        ema_nimg = ema_kimg * 1000
        if ema_rampup is not None:
            ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
        beta = 0.5 ** (batch_size / max(ema_nimg, 1e-8))
        with torch.no_grad():
            src = G.state_dict()
            for name, e in self.nets["G_ema"].state_dict().items():
                if name.split(".")[-1] in EMA_COPIED:
                    e.copy_(src[name])
                else:
                    e.copy_(src[name] + (e - src[name]) * beta)
        return dict(sorted(stats.items()))
