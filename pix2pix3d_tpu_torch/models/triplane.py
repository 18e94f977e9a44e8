"""Tri-plane generators and neural-field decoders, port of
`pix2pix3d_tpu/models/triplane.py` (ref `training/triplane.py`,
`training/triplane_cond.py`).

Every generator of the JAX package's registry:
- `TriPlaneSemanticEntangleGenerator`, the shipped pix2pix3D model (ref
  `triplane_cond.py:976-1079`): one conditional StyleGAN2 backbone emits
  3x32-channel planes, the lateSeparate two-MLP decoder yields rgb features
  + (sigma, semantic logits), a volume renderer composites a 64-channel
  feature image, and its rgb and semantic halves are super-resolved
  separately, or as one grouped pass with `rendering_kwargs['dual_sr']`;
- `TriPlaneGenerator`, conditional EG3D without the semantic branch (what
  train.py builds with `--render_mask False`, its default): `OSGDecoder`,
  one SR stack;
- `TriPlaneSemanticEntangleGeneratorWithBG` (`--use_bg True`): a second
  StyleGAN2 backbone draws an equirectangular 64-channel background plane,
  composited behind the render; it also returns the `weight` image;
- `TriPlaneSemanticGenerator`: separate texture and semantic backbones and
  decoders, importance sampler only.

Two samplers: the two-pass importance renderer (`render/renderer.py`, the
default, as in the JAX package) and the frustum-slab serving renderer
(`rendering_kwargs['sampler'] = 'frustum'`).  The lateSeparate decoder's
`impl="kernel"` (the JAX package's `impl="pallas"`) runs the hand-written
kernel (`ops/late_separate_decode.py`); like the JAX package, the
importance branch calls the decoder with its default `impl="ref"`, and the
kernel is reached through that argument, e.g.
`G.renderer(planes, lambda f, d: G.decoder(f, d, impl="kernel"), ...)`.

Inputs and outputs keep the JAX package's layouts: mask `[N, H, W, 1]`,
images `[N, H, W, C]`, planes `[N, 3, H, W, C]`.

The forward's stages run inside `torch.profiler.record_function` ranges
(`STAGES`), so a profiler over a real request reads each stage's time.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.profiler import record_function

from .. import resolve_device
from ..nn.cond_mapping import (EdgeMappingNetwork, EdgeMappingNetworkDisentangle,
                               MaskMappingNetwork, MaskMappingNetworkDisentangle)
from ..nn.layers import FullyConnected
from ..nn.superresolution import (build_superresolution, dual_sr_compatible,
                                  dual_superresolution)
from ..nn.synthesis import Generator as StyleGAN2Backbone
from ..nn.synthesis import SynthesisNetwork
from ..ops import precision
from ..ops import late_separate_decode as lsd
from ..ops.bias_act import softplus
from ..ops.decode_composite import (fuse_late_separate_params,
                                    fuse_late_separate_params_t)
from ..ops.grid_sample import grid_sample_2d
from ..render.frustum import frustum_render
from ..render.ray_sampler import sample_rays
from ..render.renderer import ImportanceRenderer, render_rays, sample_from_planes


MAPPING_REGISTRY = {
    "MaskMappingNetwork": MaskMappingNetwork,
    "MaskMappingNetwork_disentangle": MaskMappingNetworkDisentangle,
    "EdgeMappingNetwork": EdgeMappingNetwork,
    "EdgeMappingNetwork_disentangle": EdgeMappingNetworkDisentangle,
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


def _mlp_on_points(mlp, sampled_features):
    """The plane-mean features `[N, 3, M, C]` through `mlp`, row-wise:
    `[N, M, out]`."""
    x = sampled_features.mean(dim=1)
    n, m, c = x.shape
    return mlp(x.reshape(n * m, c)).reshape(n, m, -1)


class OSGDecoder(nn.Module):
    """Tri-plane MLP decoder: mean over planes -> 2-layer MLP -> (sigma, rgb)
    (ref `triplane.py:112-135`)."""

    def __init__(self, n_features, options):
        super().__init__()
        self.net = _MLP2(n_features, 64, 1 + options["decoder_output_dim"],
                         options["decoder_lr_mul"])

    def forward(self, sampled_features, ray_directions):
        x = _mlp_on_points(self.net, sampled_features)
        return {"rgb": _sigmoid_clamp(x[..., 1:]), "sigma": x[..., 0:1]}


class OSGDecoderSemantic(OSGDecoder):
    """Semantic-branch decoder, its final sigmoid optional (ref
    `triplane_cond.py:859-887`)."""

    def __init__(self, n_features, options):
        super().__init__(n_features, options)
        self.final_sigmoid = options["sigmoid"]

    def forward(self, sampled_features, ray_directions):
        x = _mlp_on_points(self.net, sampled_features)
        rgb = _sigmoid_clamp(x[..., 1:]) if self.final_sigmoid else x[..., 1:]
        return {"rgb": rgb, "sigma": x[..., 0:1]}


class OSGDecoderSemanticEntangle(nn.Module):
    """One MLP emitting rgb + semantic + features, the sigmoid on all of
    them or on all but the semantic logits (ref `triplane_cond.py:891-924`)."""

    def __init__(self, n_features, options):
        super().__init__()
        self.net = _MLP2(n_features, 64, 1 + options["decoder_output_dim"],
                         options["decoder_lr_mul"])
        self.feature_sigmoid = options["sigmoid"]
        self.semantic_channels = options["semantic_channels"]

    def forward(self, sampled_features, ray_directions):
        x = _mlp_on_points(self.net, sampled_features)
        if self.feature_sigmoid:
            feature = _sigmoid_clamp(x[..., 1:])
        else:
            s = self.semantic_channels
            feature = torch.cat([_sigmoid_clamp(x[..., 1:4]), x[..., 4:4 + s],
                                 _sigmoid_clamp(x[..., 4 + s:])], dim=-1)
        return {"rgb": feature, "sigma": x[..., 0:1]}


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


def _image(samples, nrr):
    """Row-major samples `[N, nrr*nrr, C]` -> NCHW image."""
    return samples.reshape(samples.shape[0], nrr, nrr, -1).permute(0, 3, 1, 2)


def _split_features(feats, depths, nrr, semantic_channels):
    """Feature samples of a semantic generator -> (rgb features, semantic
    features, rgb image, semantic image) NCHW and the depth image NHWC."""
    feature_image = _image(feats, nrr)
    half = feature_image.shape[1] // 2
    rgb_feats, sem_feats = feature_image[:, :half], feature_image[:, half:]
    return (rgb_feats, sem_feats, rgb_feats[:, :3], sem_feats[:, :semantic_channels],
            depths.reshape(-1, nrr, nrr, 1))


def _semantic_outputs(sr_image, sr_semantic, rgb_image, semantic_image, depth_image):
    return {"image": _nhwc(sr_image), "image_raw": _nhwc(rgb_image),
            "image_depth": depth_image, "semantic": _nhwc(sr_semantic),
            "semantic_raw": _nhwc(semantic_image)}


def _sem_precision(rk):
    """rendering_kwargs['sr_sem_precision'], or "highest" for the legacy
    flag sr_sem_f32, or None."""
    sem_prec = rk.get("sr_sem_precision")
    if sem_prec is None and rk.get("sr_sem_f32"):
        sem_prec = "highest"
    return sem_prec


class _TriPlaneBase(nn.Module):
    """The generators' shared plumbing: the conditional mapping, the
    render of a plane set on either sampler, the forward."""

    def _init_common(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                     rendering_kwargs):
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.neural_rendering_resolution = 64
        self.rendering_kwargs = rendering_kwargs or {}
        self.renderer = ImportanceRenderer()

    def _sr(self, name, img_resolution, sr_num_fp16_res, sr_kwargs, **kw):
        rk = self.rendering_kwargs
        return build_superresolution(
            rk[name], channels=32, img_resolution=img_resolution,
            sr_num_fp16_res=sr_num_fp16_res, sr_antialias=rk["sr_antialias"],
            **kw, **(sr_kwargs or {}))

    def _pose_c(self, c):
        if self.rendering_kwargs["c_gen_conditioning_zero"]:
            c = torch.zeros_like(c)
        return c * self.rendering_kwargs.get("c_scale", 0)

    def mapping(self, z, c, batch, truncation_psi=1.0, truncation_cutoff=None):
        return self.backbone.mapping(
            z, self._pose_c(c), batch=batch, truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff)

    def _planes(self, ws, noise_mode, force_fp32, generator):
        with record_function(STAGES[1]):
            return _reshape_planes(self.backbone.synthesis(
                ws, noise_mode=noise_mode, force_fp32=force_fp32,
                generator=generator))

    def _render_planes(self, planes, c, nrr, generator=None, det=False):
        """(features `[N, R, C]`, depth `[N, R, 1]`, weight sum `[N, R, 1]`,
        ray directions `[N, R, 3]`) of the camera `c` at `nrr`²."""
        rk = self.rendering_kwargs
        cam2world, intrinsics = _parse_pose(c)
        ray_origins, ray_directions = sample_rays(cam2world, intrinsics, nrr)
        if rk.get("sampler") != "frustum":
            out = self.renderer(planes, self.decoder, ray_origins, ray_directions,
                                rk, generator=generator, det=det)
            return (*out, ray_directions)
        if rk.get("frustum_tiles") is not None:
            raise NotImplementedError(
                "rendering_kwargs['frustum_tiles'] (per-output-tile "
                "sub-windows) is not ported yet: ROADMAP.md Queue 1 item 7")
        impl = rk.get("decoder_impl")
        if impl not in DECODER_IMPLS:
            raise ValueError(f"rendering_kwargs['decoder_impl'] {impl!r} is not "
                             f"one of {DECODER_IMPLS}")
        fused = None
        if impl in ("kernel", "pallas"):
            if not isinstance(self.decoder, OSGDecoderSemanticLateSeparate):
                raise ValueError(
                    f"rendering_kwargs['decoder_impl']={impl!r} requires the "
                    "OSGDecoderSemanticLateSeparate decoder (the fused kernel "
                    f"hard-codes its topology); got {type(self.decoder).__name__}. "
                    "Drop decoder_impl or use the lateSeparate generator configs.")
            fused = (*fuse_late_separate_params_t(self.decoder, self.decoder.lr_mul),
                     self.decoder.semantic_sigmoid)
        out = frustum_render(
            planes, self.decoder, cam2world, intrinsics, rk, nrr,
            depth_steps=rk.get("frustum_depth_steps"),
            chunk=rk.get("frustum_chunk"),
            window=rk.get("frustum_window"),
            compute_dtype=(torch.bfloat16 if rk.get("frustum_bf16", True)
                           else torch.float32),
            fused_decoder=fused)
        return (*out, ray_directions)

    def _sr_call(self, module, stage, img, feats, ws, generator, force_fp32):
        with record_function(stage):
            return module(img, feats, ws,
                          noise_mode=self.rendering_kwargs["superresolution_noise_mode"],
                          force_fp32=force_fp32, generator=generator)

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


class TriPlaneGenerator(_TriPlaneBase):
    """Conditional EG3D without the semantic branch (ref `triplane_cond.py
    :627-715`).  Outputs {image, image_raw, image_depth, planes}, NHWC.
    `semantic_channels` is accepted and unused, as in the JAX package (the
    mapping's encoder reads the label map's classes from its own kwargs)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 sr_num_fp16_res=0, mapping_kwargs=None, rendering_kwargs=None,
                 sr_kwargs=None, semantic_channels=None, data_type=None,
                 **synthesis_kwargs):
        super().__init__()
        self._init_common(z_dim, c_dim, w_dim, img_resolution, img_channels,
                          rendering_kwargs)
        self.data_type = data_type
        self.backbone = GeneratorCond(z_dim, c_dim, w_dim, img_resolution=256,
                                      img_channels=32 * 3,
                                      mapping_kwargs=mapping_kwargs,
                                      **synthesis_kwargs)
        self.superresolution = self._sr("superresolution_module", img_resolution,
                                        sr_num_fp16_res, sr_kwargs)
        self.decoder = OSGDecoder(
            32, {"decoder_lr_mul": self.rendering_kwargs.get("decoder_lr_mul", 1),
                 "decoder_output_dim": 32})

    def synthesis(self, ws, c, neural_rendering_resolution=None,
                  noise_mode="random", force_fp32=False, det=False,
                  generator=None, planes=None):
        """Planes (from ws, unless cached `planes` are given), render, SR;
        `generator` feeds the backbone's noise, the importance renderer's
        jitter and the SR stack's noise, in that order."""
        nrr = neural_rendering_resolution or self.neural_rendering_resolution
        if planes is None:
            planes = self._planes(ws, noise_mode, force_fp32, generator)
        with record_function(STAGES[2]):
            feats, depths, _, _ = self._render_planes(planes, c, nrr,
                                                      generator=generator, det=det)
        feature_image = _image(feats, nrr)
        rgb_image = feature_image[:, :3]
        sr_image = self._sr_call(self.superresolution, STAGES[3], rgb_image,
                                 feature_image, ws, generator, force_fp32)
        return {"image": _nhwc(sr_image), "image_raw": _nhwc(rgb_image),
                "image_depth": depths.reshape(-1, nrr, nrr, 1), "planes": planes}


class TriPlaneSemanticEntangleGenerator(_TriPlaneBase):
    """The shipped pix2pix3D model.  Outputs {image, image_raw, image_depth,
    semantic, semantic_raw, planes}, NHWC."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 semantic_channels, sr_num_fp16_res=0, mapping_kwargs=None,
                 rendering_kwargs=None, sr_kwargs=None, data_type=None,
                 **synthesis_kwargs):
        super().__init__()
        self._init_common(z_dim, c_dim, w_dim, img_resolution, img_channels,
                          rendering_kwargs)
        self.semantic_channels = semantic_channels
        self.data_type = data_type
        self.backbone = GeneratorCond(z_dim, c_dim, w_dim, img_resolution=256,
                                      img_channels=32 * 3,
                                      mapping_kwargs=mapping_kwargs,
                                      **synthesis_kwargs)
        self.superresolution = self._sr("superresolution_module", img_resolution,
                                        sr_num_fp16_res, sr_kwargs)
        self.superresolution_semantic = self._sr(
            "superresolution_module_semantic", img_resolution, sr_num_fp16_res,
            sr_kwargs, semantic_channels=semantic_channels)
        self.decoder = OSGDecoderSemanticLateSeparate(
            32, {"decoder_lr_mul": self.rendering_kwargs.get("decoder_lr_mul", 1),
                 "decoder_output_dim": 32, "sigmoid": semantic_channels == 1})

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
            planes = self._planes(ws, noise_mode, force_fp32, generator)
        with record_function(STAGES[2]):
            feats, depths, _, _ = self._render_planes(planes, c, nrr,
                                                      generator=generator, det=det)
        rgb_feats, sem_feats, rgb_image, semantic_image, depth_image = \
            _split_features(feats, depths, nrr, self.semantic_channels)
        rk = self.rendering_kwargs

        # sr_sem_precision: the semantic SR stack at f32 activations, its
        # matmuls at the graded level (ops/precision.py); the legacy flag
        # sr_sem_f32 means "highest", as in the JAX package.  It takes
        # priority over dual_sr (the two stacks would run at different
        # precisions), as there.
        sem_prec = _sem_precision(rk)
        if (sem_prec is None and rk.get("dual_sr")
                and dual_sr_compatible(self.superresolution,
                                       self.superresolution_semantic)):
            with record_function(STAGES[3]):
                sr_image, sr_semantic = dual_superresolution(
                    self.superresolution, self.superresolution_semantic,
                    rgb_image, rgb_feats, semantic_image, sem_feats, ws,
                    noise_mode=rk["superresolution_noise_mode"],
                    generator=generator, force_fp32=force_fp32)
        else:
            sr_image = self._sr_call(self.superresolution, STAGES[3], rgb_image,
                                     rgb_feats, ws, generator, force_fp32)
            with precision.scope(sem_prec):
                sr_semantic = self._sr_call(
                    self.superresolution_semantic, STAGES[4], semantic_image,
                    sem_feats, ws, generator, force_fp32 or sem_prec is not None)
        return dict(_semantic_outputs(sr_image, sr_semantic, rgb_image,
                                      semantic_image, depth_image), planes=planes)


class TriPlaneSemanticEntangleGeneratorWithBG(TriPlaneSemanticEntangleGenerator):
    """The shipped model plus an equirectangular background plane (ref
    `triplane_cond.py:1085-1246`): a second StyleGAN2 backbone renders a
    64-channel 256² plane from the last w, sampled by spherical ray
    direction and composited `fg + bg * (1 - weight)`; also outputs the
    `weight` silhouette image `[N, nrr, nrr, 1]`.  As in the JAX package,
    its SR stacks always run separately at the forward's precision
    (`dual_sr` and `sr_sem_precision` do not apply)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 semantic_channels, sr_num_fp16_res=0, mapping_kwargs=None,
                 rendering_kwargs=None, sr_kwargs=None, data_type=None,
                 **synthesis_kwargs):
        super().__init__(z_dim, c_dim, w_dim, img_resolution, img_channels,
                         semantic_channels, sr_num_fp16_res=sr_num_fp16_res,
                         mapping_kwargs=mapping_kwargs,
                         rendering_kwargs=rendering_kwargs, sr_kwargs=sr_kwargs,
                         data_type=data_type, **synthesis_kwargs)
        self.backbone_bg = StyleGAN2Backbone(z_dim, 0, w_dim, img_resolution=256,
                                             img_channels=32 * 2, mapping_kwargs={},
                                             **synthesis_kwargs)

    def synthesis(self, ws, c, neural_rendering_resolution=None,
                  noise_mode="random", force_fp32=False, det=False,
                  generator=None, planes=None):
        """As the shipped model's; `generator` feeds the backbone's noise,
        the renderer's jitter, the background backbone's noise and the SR
        stacks' noise, in that order."""
        nrr = neural_rendering_resolution or self.neural_rendering_resolution
        if planes is None:
            planes = self._planes(ws, noise_mode, force_fp32, generator)
        with record_function(STAGES[2]):
            feats, depths, weights, ray_directions = self._render_planes(
                planes, c, nrr, generator=generator, det=det)
            # the background plane from the last w, broadcast (ref :1160-1162)
            ws_bg = ws[:, -1:, :].repeat(1, self.backbone_bg.num_ws, 1)
            planes_bg = self.backbone_bg.synthesis(
                ws_bg, noise_mode=noise_mode, force_fp32=force_fp32,
                generator=generator)                          # [N, 64, 256, 256]
            feats, depths = self._combine_fg_bg(feats, depths, weights,
                                                _nhwc(planes_bg), ray_directions)
        rgb_feats, sem_feats, rgb_image, semantic_image, depth_image = \
            _split_features(feats, depths, nrr, self.semantic_channels)
        sr_image = self._sr_call(self.superresolution, STAGES[3], rgb_image,
                                 rgb_feats, ws, generator, force_fp32)
        sr_semantic = self._sr_call(self.superresolution_semantic, STAGES[4],
                                    semantic_image, sem_feats, ws, generator,
                                    force_fp32)
        return dict(_semantic_outputs(sr_image, sr_semantic, rgb_image,
                                      semantic_image, depth_image),
                    weight=weights.reshape(-1, nrr, nrr, 1), planes=planes)

    def _combine_fg_bg(self, feats, depths, weights, planes_bg, ray_directions):
        """Ref `triplane_cond.py:1202-1246`: the background at each ray's
        (azimuth, polar angle), border padding; the semantic part's class 0
        set to 20 and the other classes to 0 when there are several."""
        d = ray_directions / torch.linalg.norm(ray_directions, dim=-1, keepdim=True)
        x = torch.atan2(d[..., 1], d[..., 0]) * 2 / math.pi
        y = torch.acos(d[..., 2]) * 2 / math.pi - 1
        bg = grid_sample_2d(planes_bg, torch.stack([x, y], dim=-1),
                            padding_mode="border")            # [N, M, 64]
        bg = _sigmoid_clamp(bg) * 2 - 1
        rgb_part, sem_part = bg[..., :32], bg[..., 32:] * 10
        if self.semantic_channels > 1:
            s = self.semantic_channels
            sem_part = torch.cat([torch.full_like(sem_part[..., :1], 20.0),
                                  torch.zeros_like(sem_part[..., 1:s]),
                                  sem_part[..., s:]], dim=-1)
        bg = torch.cat([rgb_part, sem_part], dim=-1)
        feats = feats + bg * (1 - weights)
        depths = depths + self.rendering_kwargs["ray_end"] * (1 - weights)
        return feats, depths


class TriPlaneSemanticGenerator(_TriPlaneBase):
    """Two backbones (ref `triplane_cond.py:723-854`): a StyleGAN2 texture
    backbone from z and a conditional semantic backbone (z_dim 0) from the
    mask; ws `[N, num_ws, 2 * w_dim]` (texture | semantic).  The semantic
    planes give sigma and the semantic features, both plane sets the
    texture decoder's input.  Importance sampler only, no `planes` cache and
    no `sample_mixed`, as in the JAX package."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 semantic_channels, sr_num_fp16_res=0, mapping_kwargs=None,
                 rendering_kwargs=None, sr_kwargs=None, data_type=None,
                 **synthesis_kwargs):
        super().__init__()
        self._init_common(z_dim, c_dim, w_dim, img_resolution, img_channels,
                          rendering_kwargs)
        self.semantic_channels = semantic_channels
        self.data_type = data_type
        self.backbone = StyleGAN2Backbone(z_dim, c_dim, w_dim, img_resolution=256,
                                          img_channels=32 * 3, mapping_kwargs={},
                                          **synthesis_kwargs)
        self.backbone_semantic = GeneratorCond(0, c_dim, w_dim, img_resolution=256,
                                               img_channels=32 * 3,
                                               mapping_kwargs=mapping_kwargs,
                                               **synthesis_kwargs)
        self.superresolution = self._sr("superresolution_module", img_resolution,
                                        sr_num_fp16_res, sr_kwargs)
        self.superresolution_semantic = self._sr(
            "superresolution_module_semantic", img_resolution, sr_num_fp16_res,
            sr_kwargs, semantic_channels=semantic_channels)
        lr_mul = self.rendering_kwargs.get("decoder_lr_mul", 1)
        self.decoder = OSGDecoder(64, {"decoder_lr_mul": lr_mul,
                                       "decoder_output_dim": 32})
        self.decoder_semantic = OSGDecoderSemantic(
            32, {"decoder_lr_mul": lr_mul, "decoder_output_dim": 32,
                 "sigmoid": semantic_channels == 1})

    def mapping(self, z, c, batch, truncation_psi=1.0, truncation_cutoff=None):
        c = self._pose_c(c)
        ws_texture = self.backbone.mapping(z, c, truncation_psi=truncation_psi,
                                           truncation_cutoff=truncation_cutoff)
        ws_semantic = self.backbone_semantic.mapping(
            None, c, batch=batch, truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff)
        return torch.cat([ws_texture, ws_semantic], dim=-1)

    def _run_model(self, planes_texture, planes_semantic, coords, dirs):
        """Ref `ImportanceSemanticRenderer.run_model` (`renderer.py:324-333`)."""
        bw = self.rendering_kwargs["box_warp"]
        feats_t = sample_from_planes(planes_texture, coords, box_warp=bw)
        feats_s = sample_from_planes(planes_semantic, coords, box_warp=bw)
        out_s = self.decoder_semantic(feats_s, dirs)
        out_t = self.decoder(torch.cat([feats_t, feats_s], dim=-1), dirs)
        return {"sigma": out_s["sigma"],
                "rgb": torch.cat([out_t["rgb"], out_s["rgb"]], dim=-1)}

    def synthesis(self, ws, c, neural_rendering_resolution=None,
                  noise_mode="random", force_fp32=False, det=False,
                  generator=None):
        """`generator` feeds the texture backbone's noise, the semantic
        backbone's, the renderer's jitter and the SR stacks' noise, in that
        order."""
        nrr = neural_rendering_resolution or self.neural_rendering_resolution
        if ws.shape[-1] != 2 * self.w_dim:
            raise ValueError(f"ws {tuple(ws.shape)}: the last dim holds texture "
                             f"and semantic ws, 2 x {self.w_dim}")
        ws_texture, ws_semantic = ws[..., :self.w_dim], ws[..., self.w_dim:]
        kw = dict(noise_mode=noise_mode, force_fp32=force_fp32, generator=generator)
        with record_function(STAGES[1]):
            planes_t = _reshape_planes(self.backbone.synthesis(ws_texture, **kw))
            planes_s = _reshape_planes(self.backbone_semantic.synthesis(ws_semantic,
                                                                        **kw))
        with record_function(STAGES[2]):
            cam2world, intrinsics = _parse_pose(c)
            ray_origins, ray_directions = sample_rays(cam2world, intrinsics, nrr)
            feats, depths, _ = render_rays(
                lambda coords, dirs: self._run_model(planes_t, planes_s, coords, dirs),
                ray_origins, ray_directions, self.rendering_kwargs,
                generator=generator, det=det)
        rgb_feats, sem_feats, rgb_image, semantic_image, depth_image = \
            _split_features(feats, depths, nrr, self.semantic_channels)
        sr_image = self._sr_call(self.superresolution, STAGES[3], rgb_image,
                                 rgb_feats, ws_texture, generator, force_fp32)
        sr_semantic = self._sr_call(self.superresolution_semantic, STAGES[4],
                                    semantic_image, sem_feats, ws_semantic,
                                    generator, force_fp32)
        return _semantic_outputs(sr_image, sr_semantic, rgb_image, semantic_image,
                                 depth_image)

    def sample_mixed(self, *args, **kwargs):
        raise NotImplementedError(
            "TriPlaneSemanticGenerator has no sample_mixed (nor has the JAX "
            "package's): its field needs both plane sets")


GENERATOR_REGISTRY = {
    "TriPlaneGenerator": TriPlaneGenerator,
    "TriPlaneSemanticGenerator": TriPlaneSemanticGenerator,
    "TriPlaneSemanticEntangleGenerator": TriPlaneSemanticEntangleGenerator,
    "TriPlaneSemanticEntangleGenerator_withBG": TriPlaneSemanticEntangleGeneratorWithBG,
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
    `[num_ws, w_dim]`; a one-vector w_avg (the entangled mappings) takes
    the first row."""
    mapping = G.backbone.mapping
    w_avg = getattr(mapping, "w_avg", None)
    if w_avg is None:
        return
    if w_avg.ndim == 1 and ws_mean.ndim == 2:
        ws_mean = ws_mean[0]
    w_avg.copy_(ws_mean + mapping.w_avg_beta * (w_avg - ws_mean))
