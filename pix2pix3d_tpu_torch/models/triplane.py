"""The flagship tri-plane generator, port of `pix2pix3d_tpu/models/triplane.py`.

`TriPlaneSemanticEntangleGenerator` (ref `triplane_cond.py:976-1079`): one
conditional StyleGAN2 backbone emits 3x32-channel planes, the lateSeparate
two-MLP decoder yields rgb features + (sigma, semantic logits), a volume
renderer composites a 64-channel feature image, and its rgb and semantic
halves are super-resolved separately.  Both samplers are ported: the
two-pass importance renderer (`render/renderer.py`, the default, as in the
JAX package) and the frustum-slab serving renderer
(`rendering_kwargs['sampler'] = 'frustum'`).

The decoder's `impl="kernel"` (the JAX package's `impl="pallas"`) runs the
hand-written lateSeparate kernel (`ops/late_separate_decode.py`); like the
JAX package, the importance branch calls the decoder with its default
`impl="ref"`, and the kernel is reached through that argument, e.g.
`G.renderer(planes, lambda f, d: G.decoder(f, d, impl="kernel"), ...)`.

Inputs and outputs keep the JAX package's layouts: mask `[N, H, W, 1]`,
images `[N, H, W, C]`, planes `[N, 3, H, W, C]`.

The forward's stages run inside `torch.profiler.record_function` ranges
(`STAGES`), so a profiler over a real request reads each stage's time.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from .. import resolve_device
from ..nn.cond_mapping import (EdgeMappingNetworkDisentangle,
                               MaskMappingNetworkDisentangle)
from ..nn.layers import FullyConnected
from ..nn.superresolution import build_superresolution
from ..nn.synthesis import SynthesisNetwork
from ..ops import precision
from ..ops import late_separate_decode as lsd
from ..ops.bias_act import softplus
from ..ops.decode_composite import (fuse_late_separate_params,
                                    fuse_late_separate_params_t)
from ..render.frustum import frustum_render
from ..render.ray_sampler import sample_rays
from ..render.renderer import ImportanceRenderer


def _entangled_mapping(name):
    def build(**kwargs):
        raise NotImplementedError(
            f"{name} (the entangled mapping) is not ported yet: ROADMAP.md "
            "Queue 1 item 6")
    return build


MAPPING_REGISTRY = {
    "MaskMappingNetwork_disentangle": MaskMappingNetworkDisentangle,
    "EdgeMappingNetwork_disentangle": EdgeMappingNetworkDisentangle,
    "MaskMappingNetwork": _entangled_mapping("MaskMappingNetwork"),
    "EdgeMappingNetwork": _entangled_mapping("EdgeMappingNetwork"),
}

# profiler range names of the forward's stages, in order
STAGES = ("mapping", "backbone", "render", "sr_rgb", "sr_semantic")
# rendering_kwargs['decoder_impl'] of the frustum sampler: None (and the JAX
# package's "ref", its alias) decodes and composites in PyTorch ops; "kernel"
# (and the JAX package's "pallas", its alias) runs the fused decode+composite
# kernel
DECODER_IMPLS = (None, "ref", "kernel", "pallas")


def _sigmoid_clamp(x):
    """MipNeRF sigmoid clamping (ref `triplane.py:133`)."""
    return torch.sigmoid(x) * (1 + 2 * 0.001) - 0.001


class _MLP2(nn.Module):
    """FullyConnected -> softplus -> FullyConnected (the OSG decoder body)."""

    def __init__(self, n_in, n_hidden, n_out, lr_mul):
        super().__init__()
        self.fc0 = FullyConnected(n_in, n_hidden, lr_multiplier=lr_mul)
        self.fc1 = FullyConnected(n_hidden, n_out, lr_multiplier=lr_mul)

    def forward(self, x):
        return self.fc1(softplus(self.fc0(x)))


class OSGDecoderSemanticLateSeparate(nn.Module):
    """Two parallel 2-layer MLPs over the same plane features; sigma from
    the semantic head (ref `triplane_cond.py:926-970`)."""

    def __init__(self, n_features, options):
        super().__init__()
        out = 1 + options["decoder_output_dim"]
        self.lr_mul = options["decoder_lr_mul"]
        self.net = _MLP2(n_features, 64, out, self.lr_mul)
        self.net_semantic = _MLP2(n_features, 64, out, self.lr_mul)
        self.semantic_sigmoid = options["sigmoid"]

    def forward(self, sampled_features, ray_directions, impl="ref"):
        """`impl="ref"`: the two MLPs layer by layer; `impl="kernel"`: both
        MLPs and the epilogue in the lateSeparate kernel, at the features'
        dtype (JAX `triplane.py:149-162`)."""
        x = sampled_features.mean(dim=1)                      # [N, M, C]
        n, m, c = x.shape
        x = x.reshape(n * m, c)
        if impl == "kernel":
            w1, b1, w2, b2 = fuse_late_separate_params(self, self.lr_mul)
            colors, sigma = lsd.late_separate_decode(
                x, w1, b1, w2, b2, rgb_sigmoid=True,
                sem_sigmoid=self.semantic_sigmoid, compute_dtype=x.dtype)
            return {"rgb": colors.reshape(n, m, -1),
                    "sigma": sigma.reshape(n, m, 1)}
        if impl != "ref":
            raise ValueError(f"impl {impl!r} is not 'ref' or 'kernel'")
        rgb = self.net(x).reshape(n, m, -1)
        semantic = self.net_semantic(x).reshape(n, m, -1)
        sigma = semantic[..., 0:1]
        rgb = _sigmoid_clamp(rgb[..., 1:])
        semantic = (_sigmoid_clamp(semantic[..., 1:]) if self.semantic_sigmoid
                    else semantic[..., 1:])
        return {"rgb": torch.cat([rgb, semantic], dim=-1), "sigma": sigma}


class GeneratorCond(nn.Module):
    """SynthesisNetwork + conditional mapping (ref `Generator_cond`)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_kwargs=None, **synthesis_kwargs):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim=w_dim, img_resolution=img_resolution,
                                          img_channels=img_channels,
                                          **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        mk = dict(mapping_kwargs or {})
        cls = MAPPING_REGISTRY[mk.pop("class_name",
                                      "MaskMappingNetwork_disentangle")
                               .split(".")[-1]]
        self.mapping = cls(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                           num_ws=self.num_ws, **mk)


def _reshape_planes(planes_img, n_planes=3, c=32):
    """Backbone image `[N, n_planes*c, H, W]` -> planes `[N, n_planes, H, W, c]`
    (channel index `plane*c + feat`, ref `triplane_cond.py:1042`)."""
    n, _, h, w = planes_img.shape
    return planes_img.reshape(n, n_planes, c, h, w).permute(0, 1, 3, 4, 2)


def _parse_pose(c):
    return c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class TriPlaneSemanticEntangleGenerator(nn.Module):
    """The shipped pix2pix3D model.  Outputs {image, image_raw, image_depth,
    semantic, semantic_raw, planes}, NHWC."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 semantic_channels, sr_num_fp16_res=0, mapping_kwargs=None,
                 rendering_kwargs=None, sr_kwargs=None, data_type=None,
                 **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.semantic_channels = semantic_channels
        self.data_type = data_type
        self.backbone = GeneratorCond(z_dim, c_dim, w_dim, img_resolution=256,
                                      img_channels=32 * 3,
                                      mapping_kwargs=mapping_kwargs,
                                      **synthesis_kwargs)
        rendering_kwargs = rendering_kwargs or {}
        sr_common = dict(channels=32, img_resolution=img_resolution,
                         sr_num_fp16_res=sr_num_fp16_res,
                         sr_antialias=rendering_kwargs["sr_antialias"],
                         **(sr_kwargs or {}))
        self.superresolution = build_superresolution(
            rendering_kwargs["superresolution_module"], **sr_common)
        self.superresolution_semantic = build_superresolution(
            rendering_kwargs["superresolution_module_semantic"],
            semantic_channels=semantic_channels, **sr_common)
        self.decoder = OSGDecoderSemanticLateSeparate(
            32, {"decoder_lr_mul": rendering_kwargs.get("decoder_lr_mul", 1),
                 "decoder_output_dim": 32, "sigmoid": semantic_channels == 1})
        self.neural_rendering_resolution = 64
        self.rendering_kwargs = rendering_kwargs
        self.renderer = ImportanceRenderer()

    def mapping(self, z, c, batch, truncation_psi=1.0, truncation_cutoff=None):
        if self.rendering_kwargs["c_gen_conditioning_zero"]:
            c = torch.zeros_like(c)
        return self.backbone.mapping(
            z, c * self.rendering_kwargs.get("c_scale", 0), batch=batch,
            truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)

    def _render_planes(self, planes, c, nrr, generator=None, det=False):
        rk = self.rendering_kwargs
        cam2world, intrinsics = _parse_pose(c)
        if rk.get("sampler") != "frustum":
            ray_origins, ray_directions = sample_rays(cam2world, intrinsics, nrr)
            return self.renderer(planes, self.decoder, ray_origins,
                                 ray_directions, rk, generator=generator, det=det)
        if rk.get("frustum_tiles") is not None:
            raise NotImplementedError(
                "rendering_kwargs['frustum_tiles'] (per-output-tile "
                "sub-windows) is not ported yet: ROADMAP.md Queue 1, "
                "'Frustum leftovers'")
        impl = rk.get("decoder_impl")
        if impl not in DECODER_IMPLS:
            raise ValueError(f"rendering_kwargs['decoder_impl'] {impl!r} is not "
                             f"one of {DECODER_IMPLS}")
        fused = None
        if impl in ("kernel", "pallas"):
            fused = (*fuse_late_separate_params_t(self.decoder, self.decoder.lr_mul),
                     self.decoder.semantic_sigmoid)
        return frustum_render(
            planes, self.decoder, cam2world, intrinsics, rk, nrr,
            depth_steps=rk.get("frustum_depth_steps"),
            chunk=rk.get("frustum_chunk"),
            window=rk.get("frustum_window"),
            compute_dtype=(torch.bfloat16 if rk.get("frustum_bf16", True)
                           else torch.float32),
            fused_decoder=fused)

    def synthesis(self, ws, c, neural_rendering_resolution=None,
                  noise_mode="random", force_fp32=False, det=False,
                  generator=None, planes=None):
        """Planes (from ws, unless cached `planes` `[N, 3, H, W, 32]` are
        given), render, super-resolution.  The `torch.Generator`
        `generator` feeds every random draw, in this order: the backbone's
        noise (noise_mode 'random', the default, as in the JAX package),
        the importance renderer's jitter (none with `det=True`; the
        frustum renderer takes none) and the SR stacks' noise (their
        `superresolution_noise_mode`).  A draw without a generator raises."""
        nrr = neural_rendering_resolution or self.neural_rendering_resolution
        if planes is None:
            with record_function(STAGES[1]):
                planes = _reshape_planes(self.backbone.synthesis(
                    ws, noise_mode=noise_mode, force_fp32=force_fp32,
                    generator=generator))
        with record_function(STAGES[2]):
            feats, depths, _ = self._render_planes(planes, c, nrr,
                                                   generator=generator, det=det)
        n = feats.shape[0]
        feature_image = feats.reshape(n, nrr, nrr, -1).permute(0, 3, 1, 2)
        depth_image = depths.reshape(n, nrr, nrr, 1)

        half = feature_image.shape[1] // 2
        rgb_feature_image = feature_image[:, :half]
        semantic_feature_image = feature_image[:, half:]
        rgb_image = rgb_feature_image[:, :3]
        semantic_image = semantic_feature_image[:, :self.semantic_channels]
        sr_noise_mode = self.rendering_kwargs["superresolution_noise_mode"]

        # sr_sem_precision: the semantic SR stack at f32 activations, its
        # matmuls at the graded level (ops/precision.py); the legacy flag
        # sr_sem_f32 means "highest", as in the JAX package.
        sem_prec = self.rendering_kwargs.get("sr_sem_precision")
        if sem_prec is None and self.rendering_kwargs.get("sr_sem_f32"):
            sem_prec = "highest"
        with record_function(STAGES[3]):
            sr_image = self.superresolution(
                rgb_image, rgb_feature_image, ws, noise_mode=sr_noise_mode,
                force_fp32=force_fp32, generator=generator)
        with record_function(STAGES[4]), precision.scope(sem_prec):
            sr_semantic = self.superresolution_semantic(
                semantic_image, semantic_feature_image, ws,
                noise_mode=sr_noise_mode, generator=generator,
                force_fp32=force_fp32 or sem_prec is not None)
        return {"image": _nhwc(sr_image), "image_raw": _nhwc(rgb_image),
                "image_depth": depth_image, "semantic": _nhwc(sr_semantic),
                "semantic_raw": _nhwc(semantic_image), "planes": planes}

    def sample(self, coordinates, directions, z, c, batch, truncation_psi=1.0,
               truncation_cutoff=None, **synthesis_kwargs):
        """Field evaluation from (z, mask) inputs (ref `triplane_cond.py
        :1063-1068`): mapping, then `sample_mixed`."""
        ws = self.mapping(z, batch["pose"], batch, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.sample_mixed(coordinates, directions, ws, **synthesis_kwargs)

    def sample_mixed(self, coordinates, directions, ws, noise_mode="const",
                     generator=None, force_fp32=False):
        """The neural field at 3D points `[N, M, 3]` (ref `triplane_cond.py
        :1070-1074`; mesh extraction uses it)."""
        planes = _reshape_planes(self.backbone.synthesis(
            ws, noise_mode=noise_mode, force_fp32=force_fp32,
            generator=generator))
        return self.run_model_planes(planes, coordinates, directions)

    def run_model_planes(self, planes, coordinates, directions):
        return self.renderer.run_model(planes, self.decoder, coordinates,
                                       directions, self.rendering_kwargs)

    def forward(self, z, c, batch, truncation_psi=1.0, truncation_cutoff=None,
                neural_rendering_resolution=None, **synthesis_kwargs):
        """z [N, z_dim], c [N, 25] camera, batch {'mask' [N, H, W, 1],
        'pose' [N, 25]}; `noise_mode` 'random' (the default; needs
        `generator`) | 'const' | 'none'."""
        with record_function(STAGES[0]):
            ws = self.mapping(z, batch["pose"], batch, truncation_psi=truncation_psi,
                              truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, c,
                              neural_rendering_resolution=neural_rendering_resolution,
                              **synthesis_kwargs)


GENERATOR_REGISTRY = {
    "TriPlaneSemanticEntangleGenerator": TriPlaneSemanticEntangleGenerator,
}


def init_parameters(module, generator):
    """Draw every parameter as the JAX package's `init` does, from a
    seeded `torch.Generator` (module order)."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


def build_generator(class_name, device="cuda", seed=0, train=False, **kwargs):
    """Construct a generator by (reference-compatible) class name, with
    weights drawn from `torch.Generator().manual_seed(seed)`, on `device`
    (default: the card; raises if there is none): in eval mode with frozen
    parameters for serving and the apps, or with `train=True` in train mode
    with parameters that take gradients (the trainer's G)."""
    device = resolve_device(device)
    G = GENERATOR_REGISTRY[class_name.split(".")[-1]](**kwargs)
    init_parameters(G, torch.Generator().manual_seed(seed))
    if train:
        return G.to(device).train().requires_grad_(True)
    return G.to(device).eval().requires_grad_(False)


@torch.no_grad()
def update_w_avg(G, ws_mean):
    """The D phase's w_avg update of the conditional mapping (JAX
    `parallel/trainer.py:342-358`, ref `run_G(update_emas=True)`):
    `w_avg = ws_mean + beta * (w_avg - ws_mean)` from the batch-mean ws
    `[num_ws, w_dim]`."""
    mapping = G.backbone.mapping
    w_avg = getattr(mapping, "w_avg", None)
    if w_avg is None:
        return
    if w_avg.ndim == 1 and ws_mean.ndim == 2:
        ws_mean = ws_mean[0]
    w_avg.copy_(ws_mean + mapping.w_avg_beta * (w_avg - ws_mean))
