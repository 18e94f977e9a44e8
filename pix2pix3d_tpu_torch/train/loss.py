"""Pix2Pix3D training losses as phase functions, port of
`pix2pix3d_tpu/train/loss.py` (ref `training/loss.py:372-1022`).

Each phase computes its scalar loss and stats from the modules' current
parameters; the trainer (`train/trainer.py`) differentiates it with
`torch.autograd.grad` with respect to the phase's own network.  R1 is an
inner `torch.autograd.grad(..., create_graph=True)` with respect to the real
images, differentiated again by the trainer, so every op on the
discriminator's path is twice differentiable (the port's `bias_act`,
`upfirdn2d` and `conv2d_resample` are plain PyTorch).

Layouts are the JAX package's at the boundary: `batch` holds `image` `[N,
H, W, 3]` in [-1, 1], `mask` `[N, H, W, 1]` and `pose` `[N, 25]`, and the
generator returns NHWC images (views of NCHW tensors); the discriminators
and LPIPS take NCHW, so `run_D` and the LPIPS terms permute at the call.

Randomness: one `torch.Generator` per call feeds every draw, in the order
the JAX phase splits its key: the pose coin (`draw_uniform`), the
generator's noise and renderer jitter, the density-regularization points,
directions and perturbations (`draw_uniform`/`draw_normal`), and
`disc_c_noise` (`nn.discriminator.draw_normal`).  The frameworks draw
different numbers from a seed; the tests hand JAX's draws to these hooks.
With an `augment_pipe`, a phase that takes `aug_p` first draws one seed
(`draw_seed`, JAX's `fold_in(rng, 77)`), and each of its pipe calls draws
from a generator seeded with it: the fake and the real batch of a phase
get the same transforms, as JAX's calls on one key do.

`remat=True` recomputes `run_G`'s forward in the backward pass
(`torch.utils.checkpoint`, JAX's `jax.checkpoint(run_G)`).  The recompute
draws from a copy of the generator as it stood before the forward
(`_replay_generator`), so it draws the forward's numbers again: the
checkpoint's own `preserve_rng_state` restores only PyTorch's global
generators, not the explicit one.

Loss inventory (ref lines in parens): GAN softplus G/D on the dual
discriminator (:566, :843, :866); semantic GAN via D_semantic with rgb
detached (:568-593); reconstruction smooth-L1 + LPIPS on image and raw
(:596-607); semantic reconstruction, weighted CE (seg) or smooth-L1 x
edge_weight (edge) (:611-625); silhouette MSE (:633-638); cross-view
consistency (:658-678); density regularization l1 / monotonic-detach /
monotonic-fixed (:681-825); dual R1 (:871-888) and semantic R1 (:979-1003);
random-pose training with prob `random_c_prob` (:525-530); blur fade
(:516-517) and nrr fade (:532-538).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..nn.discriminator import filtered_resizing
from ..ops.bias_act import softplus
from ..ops.resize import resize_bilinear
from ..ops.upfirdn2d import filter2d, setup_filter
from .stats import StatsAccumulator


def draw_uniform(generator, shape, device):
    """U[0, 1) draws from `generator` (on its own device), on `device`."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def draw_normal(generator, shape, device):
    """N(0, 1) draws from `generator` (on its own device), on `device`."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def draw_seed(generator):
    """A 63-bit seed drawn from `generator` (a host sync when it lives on
    the card): the phase's augmentation draws."""
    return int(torch.randint(2**62, (), generator=generator,
                             device=generator.device))


def _replay_generator(generator, state):
    """A generator on `generator`'s device in `state` (`get_state()`'s):
    what `run_G`'s recompute under remat draws from."""
    replay = torch.Generator(device=generator.device)
    replay.set_state(state)
    return replay


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def smooth_l1(x, y):
    """torch F.smooth_l1_loss (beta=1), mean-reduced."""
    return F.smooth_l1_loss(x, y, beta=1.0)


def cross_entropy2d(logits_nhwc, target_hw, weight=None):
    """Weighted pixel CE (ref `training/loss_utils.py:4-17`), mean over
    pixels with torch's weighted-mean semantics."""
    logp = torch.log_softmax(logits_nhwc, dim=-1)
    t = target_hw.long()
    picked = torch.gather(logp, -1, t[..., None])[..., 0]
    if weight is None:
        return -picked.mean()
    w_per_px = weight.to(logp.device)[t]
    return -(picked * w_per_px).sum() / w_per_px.sum()


def nearest_resize(x, size):
    """NHWC nearest-neighbor resize (torch F.interpolate mode='nearest')."""
    h = x.shape[1]
    if h == size:
        return x
    idx = (torch.arange(size, dtype=torch.float32) * (h / size)).long().to(x.device)
    return x[:, idx][:, :, idx]


# CelebAMask 19-class weights (ref `loss.py:414-427`).
SEG_WEIGHT_1 = np.array([
    0.42768099, 0.45614868, 1.59952169, 4.38863045, 4.85695198, 4.86439145,
    3.53563349, 3.57896961, 3.37838867, 3.66981824, 4.17743386, 3.5624441,
    2.78190484, 0.40917425, 2.38560636, 4.65813434, 17.17367367, 1.13303585,
    1.25281865], dtype=np.float32)
SEG_WEIGHT_2 = np.array([
    1.82911031e-01, 2.08071618e-01, 2.55846962e+00, 1.92600773e+01,
    2.35899825e+01, 2.36623042e+01, 1.25007042e+01, 1.28090235e+01,
    1.14135100e+01, 1.34675659e+01, 1.74509537e+01, 1.26910080e+01,
    7.73899453e+00, 1.67423571e-01, 5.69111768e+00, 2.16982155e+01,
    2.94935067e+02, 1.28377023e+00, 1.56955458e+00], dtype=np.float32)


class Pix2Pix3DLoss:
    """Phase losses over the (G, D, D_semantic) modules."""

    def __init__(self, G, D, D_semantic=None, lpips=None, augment_pipe=None,
                 r1_gamma=10.0, blur_init_sigma=0.0, blur_fade_kimg=0.0,
                 neural_rendering_resolution_initial=64,
                 neural_rendering_resolution_final=None,
                 neural_rendering_resolution_fade_kimg=0,
                 gpc_reg_fade_kimg=1000, gpc_reg_prob=None,
                 dual_discrimination=True, filter_mode="antialiased",
                 random_c_prob=0.0, lambda_l1=2.0, lambda_lpips=10.0,
                 lambda_D_semantic=1.0, seg_weight=0, edge_weight=2.0,
                 only_raw_recons=False, silhouette_loss=False,
                 lambda_cross_view=0.0, style_mixing_prob=0.0,
                 raw_fade_kimg=None, remat=False):
        self.G = G
        self.D = D
        self.D_semantic = D_semantic
        self.lpips = lpips
        self.augment_pipe = augment_pipe
        self.remat = remat
        self.r1_gamma = r1_gamma
        self.blur_init_sigma = blur_init_sigma
        self.blur_fade_kimg = blur_fade_kimg
        self.nrr_initial = neural_rendering_resolution_initial
        self.nrr_final = neural_rendering_resolution_final
        self.nrr_fade_kimg = neural_rendering_resolution_fade_kimg
        self.gpc_reg_fade_kimg = gpc_reg_fade_kimg
        self.gpc_reg_prob = gpc_reg_prob
        self.dual_discrimination = dual_discrimination
        self.filter_mode = filter_mode
        self.random_c_prob = random_c_prob
        self.lambda_l1 = lambda_l1
        self.lambda_lpips = lambda_lpips
        self.lambda_D_semantic = lambda_D_semantic
        self.edge_weight = edge_weight
        self.only_raw_recons = only_raw_recons
        self.silhouette_loss = silhouette_loss
        self.lambda_cross_view = lambda_cross_view
        self.raw_fade_kimg = raw_fade_kimg
        # inert, as in the reference (its application is commented out in
        # run_G, ref `loss.py:449-453`) and the JAX package, which warns
        self.style_mixing_prob = style_mixing_prob
        if style_mixing_prob:
            warnings.warn(
                "style_mixing_prob is inert: the reference comments out "
                "style mixing in run_G (loss.py:449-453) and this rebuild "
                "matches that; the value is stored but never applied.",
                stacklevel=2)
        self.resample_filter = setup_filter([1, 3, 3, 1])
        self.seg_weight = {1: torch.from_numpy(SEG_WEIGHT_1),
                           2: torch.from_numpy(SEG_WEIGHT_2)}.get(int(seg_weight))

    # ---------------------------------------------------------------- sched
    def schedule(self, cur_nimg):
        """Host-side per-step schedule."""
        blur_sigma = (max(1 - cur_nimg / (self.blur_fade_kimg * 1e3), 0)
                      * self.blur_init_sigma if self.blur_fade_kimg > 0 else 0)
        if self.nrr_final is not None:
            alpha = min(cur_nimg / (self.nrr_fade_kimg * 1e3), 1)
            nrr = int(np.rint(self.nrr_initial * (1 - alpha)
                              + self.nrr_final * alpha))
        else:
            nrr = self.nrr_initial
        raw_fade = (max(1 - cur_nimg / (self.raw_fade_kimg * 1e3), 0)
                    if self.raw_fade_kimg else None)
        return dict(blur_sigma=float(blur_sigma),
                    neural_rendering_resolution=nrr, raw_fade=raw_fade)

    # --------------------------------------------------------------- pieces
    def _blur(self, image, blur_sigma):
        """Gaussian blur of an NCHW image for the discriminator fade (ref
        `loss.py:516-517`).  `blur_sigma` is a float (kernel width
        floor(3 sigma)) or a `(sigma, kernel_half_width)` pair, as the
        trainer passes it."""
        if isinstance(blur_sigma, tuple):
            sigma, blur_size = blur_sigma
        else:
            sigma = blur_sigma
            blur_size = int(np.floor(float(blur_sigma) * 3))
        if blur_size <= 0:
            return image
        taps = torch.arange(-blur_size, blur_size + 1, dtype=torch.float32,
                            device=image.device)
        f = torch.exp2(-(taps / torch.tensor(float(sigma), dtype=torch.float32)).square())
        return filter2d(image, f / f.sum())

    def _run_G(self, z, batch, c_render, nrr, generator):
        ws = self.G.mapping(z, batch["pose"], batch)
        out = self.G.synthesis(ws, c_render, neural_rendering_resolution=nrr,
                               generator=generator, noise_mode="random")
        return out, ws

    def run_G(self, z, batch, c_render, nrr, generator):
        if not (self.remat and torch.is_grad_enabled()):
            return self._run_G(z, batch, c_render, nrr, generator)
        state = generator.get_state()
        runs = []

        def run(z, batch, c_render):
            g = _replay_generator(generator, state) if runs else generator
            runs.append(g)
            return self._run_G(z, batch, c_render, nrr, g)
        return checkpoint(run, z, batch, c_render, use_reentrant=False)

    def phase_aug(self, generator, aug_p):
        """The phase's augmentation (JAX's `fold_in(rng, 77)`): None without
        a pipe or `aug_p`, else (a maker of the phase's pipe generator,
        aug_p)."""
        if self.augment_pipe is None or aug_p is None:
            return None
        seed = draw_seed(generator)
        device = generator.device
        return (lambda: torch.Generator(device=device).manual_seed(seed)), aug_p

    def _augment_pair(self, image, image_raw, make_generator, aug_p):
        """ADA on [image | raw upsampled to the image's size] together, the
        raw resized back (JAX `loss.py:201-210`); NCHW in and out."""
        c = image.shape[1]
        raw_res = image_raw.shape[2]
        up_raw = resize_bilinear(image_raw, image.shape[2], antialias=True)
        pair = _nhwc(torch.cat([image, up_raw], dim=1))
        pair = _nchw(self.augment_pipe(pair, aug_p, make_generator()))
        return pair[:, :c], resize_bilinear(pair[:, c:], raw_res, antialias=True)

    def _run(self, net, img, c, blur_sigma, generator, raw_fade, aug):
        """NHWC image dict -> NCHW, blur the image, augment the pair (if
        `aug`), apply `net`."""
        image = self._blur(_nchw(img["image"]), blur_sigma)
        image_raw = _nchw(img["image_raw"])
        if aug is not None:
            image, image_raw = self._augment_pair(image, image_raw, *aug)
        return net({"image": image, "image_raw": image_raw}, c,
                   generator=generator, raw_fade=raw_fade)

    def run_D(self, img, c, blur_sigma, generator=None, aug=None, raw_fade=None):
        return self._run(self.D, img, c, blur_sigma, generator, raw_fade, aug)

    def run_D_semantic(self, img, c, blur_sigma, generator=None, aug=None,
                       raw_fade=None):
        return self._run(self.D_semantic, img, c, blur_sigma, generator, raw_fade,
                         aug)

    def _resize(self, x_nhwc, size):
        return _nhwc(filtered_resizing(_nchw(x_nhwc), size, f=self.resample_filter,
                                       filter_mode=self.filter_mode))

    def _semantic_concat(self, gen_img, detach_rgb):
        """[image | semantic] concat for D_semantic (ref :568-593).
        seg: softmax the logits; edge: raw channels."""
        sem = gen_img["semantic"]
        sem_raw = gen_img["semantic_raw"]
        if self.G.data_type == "seg":
            sem = torch.softmax(sem, dim=-1)
            sem_raw = torch.softmax(sem_raw, dim=-1)
        image = gen_img["image"]
        image_raw = gen_img["image_raw"]
        if detach_rgb:
            image = image.detach()
            image_raw = image_raw.detach()
        return {"image": torch.cat([image, sem], dim=-1),
                "image_raw": torch.cat([image_raw, sem_raw], dim=-1)}

    def _real_pair(self, batch, nrr, blur_sigma):
        real_img = batch["image"]
        real_raw = self._resize(real_img, nrr)
        # blur_raw_target (ref :544-549)
        real_raw = _nhwc(self._blur(_nchw(real_raw), blur_sigma))
        return {"image": real_img, "image_raw": real_raw}

    def _mode_coin(self, generator, device):
        """Bernoulli(random_c_prob) as a 0-d f32 tensor: 1 -> render under
        the random pose gen_c ('random_z_random_c'), 0 -> the image pose
        ('random_z_image_c').  Stays on the card: no host sync."""
        if self.random_c_prob <= 0:
            return torch.zeros((), device=device)
        u = draw_uniform(generator, (), device)
        return (u < self.random_c_prob).float()

    def _lpips(self, a, b):
        if self.lpips is None:
            return 0.0
        return self.lpips(_nchw(a), _nchw(b)).mean()

    # --------------------------------------------------------------- phases
    @torch.no_grad()
    def cross_view_prep(self, gen_z, batch, gen_c, generator, nrr):
        """The two no-grad renders of the cross-view term (JAX: a separate
        program with the same draws as `g_main`'s r_cv1/r_cv3)."""
        gi_rc, _ = self.run_G(gen_z, batch, gen_c, nrr, generator)
        if self.G.data_type == "seg":
            proj_mask = gi_rc["semantic"].argmax(dim=-1, keepdim=True).float()
        else:
            proj_mask = gi_rc["semantic"]
        gi_rec, _ = self.run_G(gen_z, batch, batch["pose"], nrr, generator)
        return {"proj_mask": proj_mask.contiguous(),
                "recon_sem_raw": gi_rec["semantic_raw"].contiguous()}

    def g_main(self, batch, gen_z, gen_c, generator, blur_sigma, nrr,
               aug_p=None, raw_fade=None, cv_aux=None):
        stats = StatsAccumulator()
        pose = batch["pose"]
        aug = self.phase_aug(generator, aug_p)
        coin = self._mode_coin(generator, pose.device)
        c_render = torch.where(coin > 0, gen_c, pose)
        recon_on = 1.0 - coin  # recon losses only in image-pose mode (ref :595)

        gen_img, _ws = self.run_G(gen_z, batch, c_render, nrr, generator)
        gen_logits = self.run_D(gen_img, c_render, blur_sigma, generator, aug,
                                raw_fade)
        stats.report("Loss/scores/fake", gen_logits)
        stats.report("Loss/signs/fake", torch.sign(gen_logits))
        loss = softplus(-gen_logits).mean()

        if self.D_semantic is not None:
            input_img = self._semantic_concat(gen_img, detach_rgb=True)
            logits_sem = self.run_D_semantic(input_img, c_render, blur_sigma,
                                             aug=aug, raw_fade=raw_fade)
            stats.report("Loss/scores/fake_semantic", logits_sem)
            loss = loss + softplus(-logits_sem).mean() * self.lambda_D_semantic

        # reconstruction terms (masked out under random-pose mode)
        real = self._real_pair(batch, nrr, blur_sigma=0)
        rec_full = (smooth_l1(gen_img["image"], real["image"]) * self.lambda_l1
                    + self._lpips(gen_img["image"], real["image"]) * self.lambda_lpips)
        rec_raw = (smooth_l1(gen_img["image_raw"], real["image_raw"]) * self.lambda_l1
                   + self._lpips(gen_img["image_raw"], real["image_raw"])
                   * self.lambda_lpips)
        rec = rec_full * (1 - float(self.only_raw_recons)) + rec_raw
        stats.report("Loss/G/loss_img_reconstruction", rec)
        loss = loss + rec * recon_on

        if "semantic" in gen_img:
            mask = batch["mask"]
            mask_raw = nearest_resize(mask, nrr)
            if self.G.data_type == "seg":
                sem_rec = (cross_entropy2d(gen_img["semantic"], mask[..., 0],
                                           self.seg_weight)
                           * (1 - float(self.only_raw_recons))
                           + cross_entropy2d(gen_img["semantic_raw"], mask_raw[..., 0],
                                             self.seg_weight))
            else:
                sem_rec = (smooth_l1(gen_img["semantic"], mask) * self.edge_weight
                           * (1 - float(self.only_raw_recons))
                           + smooth_l1(gen_img["semantic_raw"], mask_raw)
                           * self.edge_weight)
            stats.report("Loss/G/loss_semantic_reconstruction", sem_rec)
            loss = loss + sem_rec * recon_on

            if (self.silhouette_loss and self.G.data_type == "seg"
                    and "weight" in gen_img):
                sil = self.calculate_silhouette_loss(gen_img["weight"], mask_raw)
                stats.report("Loss/G/loss_silhouette", sil)
                loss = loss + sil * recon_on

        # cross-view consistency (ref :658-678)
        if self.lambda_cross_view > 0:
            if cv_aux is None:
                cv_aux = self.cross_view_prep(gen_z, batch, gen_c, generator, nrr)
            proj_mask, recon_sem_raw = cv_aux["proj_mask"], cv_aux["recon_sem_raw"]
            batch_proj = dict(batch, mask=proj_mask)
            gen_img_proj, _ = self.run_G(gen_z, batch_proj, pose, nrr, generator)
            cv = smooth_l1(gen_img_proj["semantic_raw"],
                           recon_sem_raw) * self.lambda_cross_view
            stats.report("Loss/G/loss_cross_view", cv)
            loss = loss + cv

        stats.report("Loss/G/loss", loss)
        return loss, stats.asdict()

    def g_reg(self, batch, gen_z, generator):
        """Density regularization (ref :681-825): 'l1' (TV between nearby
        random points), 'monotonic-detach'/'monotonic-fixed' (+ front-behind
        monotonicity)."""
        rk = self.G.rendering_kwargs
        density_reg = rk.get("density_reg", 0)
        dev = batch["pose"].device
        if density_reg == 0:
            return torch.zeros((), device=dev), {}
        reg_type = rk.get("reg_type", "l1")
        ws = self.G.mapping(gen_z, batch["pose"], batch)
        n = ws.shape[0]

        def sigma_pair(n_pts, perturb):
            initial = draw_uniform(generator, (n, n_pts, 3), dev) * 2 - 1
            coords = torch.cat([initial, initial + perturb], dim=1)
            dirs = draw_normal(generator, coords.shape, dev)
            sigma = self.G.sample_mixed(coords, dirs, ws, noise_mode="random",
                                        generator=generator)["sigma"]
            return sigma[:, :n_pts], sigma[:, n_pts:]

        if reg_type == "l1":
            pert = draw_normal(generator, (n, 1000, 3), dev) * rk["density_reg_p_dist"]
            s_i, s_p = sigma_pair(1000, pert)
            loss = (s_i - s_p).abs().mean() * density_reg
        elif reg_type in ("monotonic-detach", "monotonic-fixed"):
            behind = (torch.tensor([0.0, 0.0, -1.0], device=dev)
                      * (1 / 256) * rk["box_warp"])
            s_i, s_p = sigma_pair(2000, behind)
            if reg_type == "monotonic-detach":
                mono = F.relu(s_i.detach() - s_p).mean() * 10
            else:
                mono = F.relu(s_i - s_p).mean() * 10
            pert = draw_normal(generator, (n, 1000, 3), dev) * (1 / 256) * rk["box_warp"]
            s_i2, s_p2 = sigma_pair(1000, pert)
            loss = mono + (s_i2 - s_p2).abs().mean() * density_reg
        else:
            # 'l1-alt' / 'total-variation': CLI choices with no
            # implementation in the reference either -- no-op
            loss = torch.zeros((), device=dev)
        return loss, {}

    def d_main(self, batch, gen_z, gen_c, generator, blur_sigma, nrr,
               aug_p=None, raw_fade=None):
        stats = StatsAccumulator()
        pose = batch["pose"]
        aug = self.phase_aug(generator, aug_p)
        coin = self._mode_coin(generator, pose.device)
        c_render = torch.where(coin > 0, gen_c, pose)
        with torch.no_grad():
            gen_img, ws = self.run_G(gen_z, batch, c_render, nrr, generator)
        gen_logits = self.run_D(gen_img, c_render, blur_sigma, generator, aug,
                                raw_fade)
        stats.report("Loss/scores/fake", gen_logits)
        stats.report("Loss/signs/fake", torch.sign(gen_logits))
        loss_dgen = softplus(gen_logits).mean()

        real = self._real_pair(batch, nrr, blur_sigma)
        real_logits = self.run_D(real, pose, blur_sigma, generator, aug, raw_fade)
        stats.report("Loss/scores/real", real_logits)
        stats.report("Loss/signs/real", torch.sign(real_logits))
        loss_dreal = softplus(-real_logits).mean()
        stats.report("Loss/D/loss", loss_dgen + loss_dreal)
        # w_avg side channel: the reference updates it in the D phase's G
        # run (`run_G(update_emas=True)`, loss.py:846)
        return loss_dgen + loss_dreal, (stats.asdict(), {"ws": ws})

    def _r1_penalty(self, run, pair):
        image = pair["image"].detach().requires_grad_(True)
        image_raw = pair["image_raw"].detach().requires_grad_(True)
        out = run({"image": image, "image_raw": image_raw})
        g_img, g_raw = torch.autograd.grad(out.sum(), [image, image_raw],
                                           create_graph=True)
        penalty = g_img.square().sum(dim=(1, 2, 3))
        if self.dual_discrimination:
            penalty = penalty + g_raw.square().sum(dim=(1, 2, 3))
        return penalty

    def d_r1(self, batch, generator, blur_sigma, nrr, aug_p=None, raw_fade=None):
        """R1 on the real image and raw (ref :871-888), through the pipe
        when augmenting."""
        stats = StatsAccumulator()
        aug = self.phase_aug(generator, aug_p)
        real = self._real_pair(batch, nrr, blur_sigma)
        penalty = self._r1_penalty(
            lambda img: self.run_D(img, batch["pose"], blur_sigma, generator,
                                   aug, raw_fade), real)
        loss = penalty.mean() * (self.r1_gamma / 2)
        stats.report("Loss/r1_penalty", penalty)
        stats.report("Loss/D/reg", loss)
        return loss, stats.asdict()

    def d_semantic_main(self, batch, gen_z, gen_c, generator, blur_sigma, nrr,
                        aug_p=None, raw_fade=None):
        stats = StatsAccumulator()
        pose = batch["pose"]
        aug = self.phase_aug(generator, aug_p)
        coin = self._mode_coin(generator, pose.device)
        c_render = torch.where(coin > 0, gen_c, pose)
        with torch.no_grad():
            gen_img, _ = self.run_G(gen_z, batch, c_render, nrr, generator)
        input_img = self._semantic_concat(gen_img, detach_rgb=False)
        logits = self.run_D_semantic(input_img, c_render, blur_sigma,
                                     aug=aug, raw_fade=raw_fade)
        stats.report("Loss/scores/fake_semantic", logits)
        loss_gen = softplus(logits).mean()

        real_cat = self._real_semantic_pair(batch, nrr, blur_sigma)
        real_logits = self.run_D_semantic(real_cat, pose, blur_sigma,
                                          aug=aug, raw_fade=raw_fade)
        stats.report("Loss/scores/real_semantic", real_logits)
        loss_real = softplus(-real_logits).mean()
        stats.report("Loss/D/loss_semantic", loss_gen + loss_real)
        return loss_gen + loss_real, stats.asdict()

    def _real_semantic_pair(self, batch, nrr, blur_sigma):
        """Real [image | mask] pair for D_semantic (ref :942-963)."""
        real = self._real_pair(batch, nrr, blur_sigma)
        mask = batch["mask"]
        if self.G.data_type == "seg":
            mask = F.one_hot(mask[..., 0].long(), self.G.semantic_channels).float()
        mask_raw = self._resize(mask, nrr)
        return {"image": torch.cat([real["image"], mask], dim=-1),
                "image_raw": torch.cat([real["image_raw"], mask_raw], dim=-1)}

    def d_semantic_r1(self, batch, generator, blur_sigma, nrr, aug_p=None,
                      raw_fade=None):
        stats = StatsAccumulator()
        aug = self.phase_aug(generator, aug_p)
        real_cat = self._real_semantic_pair(batch, nrr, blur_sigma)
        penalty = self._r1_penalty(
            lambda img: self.run_D_semantic(img, batch["pose"], blur_sigma,
                                            aug=aug, raw_fade=raw_fade), real_cat)
        loss = penalty.mean() * self.r1_gamma * 0.5
        stats.report("Loss/r1_penalty_semantic", penalty)
        stats.report("Loss/D/reg_semantic", loss)
        return loss, stats.asdict()

    @staticmethod
    def calculate_silhouette_loss(weight_image, mask):
        """MSE between accumulated weights and fg mask x10 (ref :1005-1022)."""
        ref_sil = (mask > 0).float()
        return (weight_image - ref_sil).square().mean() * 10


def blur_size_bucket(blur_sigma):
    """The blur kernel's half width as the JAX trainer sizes it: floor(3
    sigma), rounded up to a multiple of 8 (`parallel/trainer.py:548-560`;
    the extra taps carry the true Gaussian weights)."""
    size = int(math.floor(blur_sigma * 3))
    return -(-size // 8) * 8 if size > 0 else 0
