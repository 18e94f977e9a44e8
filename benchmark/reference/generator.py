"""The pix2pix3D generator (`TriPlaneSemanticEntangleGenerator`), plain:
the benchmark's reference, f32 throughout.

Conditional mapping (label or edge map, z, camera) -> StyleGAN2 backbone ->
3x32-channel tri-planes -> volume render (the two-pass importance renderer,
or the frustum-slab render of the serving settings) -> the lateSeparate
decoder's 64 features per ray -> two super-resolution stacks.  Parameter
names and shapes are those of the serving program's generator, so one set
of weights loads into both.

Plain means: every product in f32 (the caller keeps TF32 off), no bf16
blocks, no hand-written kernel, no fused or packed weights, no dual SR
pass, no contraction windows.  The modules under `nn/`, `ops/` and
`render/` (the frustum excepted) are frozen copies of the program's own, so
the same arithmetic is held fixed while the program changes.
"""

from __future__ import annotations

import torch
from torch import nn

from .nn.cond_mapping import EdgeMappingNetworkDisentangle, MaskMappingNetworkDisentangle
from .nn.layers import FullyConnected
from .nn.superresolution import build_superresolution
from .nn.synthesis import SynthesisNetwork
from .ops.bias_act import softplus
from .render import frustum
from .render.ray_sampler import sample_rays
from .render.renderer import ImportanceRenderer

MAPPINGS = {"MaskMappingNetwork_disentangle": MaskMappingNetworkDisentangle,
            "EdgeMappingNetwork_disentangle": EdgeMappingNetworkDisentangle}


def _sigmoid_clamp(x):
    return torch.sigmoid(x) * (1 + 2 * 0.001) - 0.001


class _MLP2(nn.Module):
    def __init__(self, n_in, n_hidden, n_out, lr_mul):
        super().__init__()
        self.fc0 = FullyConnected(n_in, n_hidden, lr_multiplier=lr_mul)
        self.fc1 = FullyConnected(n_hidden, n_out, lr_multiplier=lr_mul)

    def forward(self, x):
        return self.fc1(softplus(self.fc0(x)))


class LateSeparateDecoder(nn.Module):
    """Two 2-layer MLPs over the plane-mean features: rgb features from the
    first, sigma and semantic features from the second."""

    def __init__(self, n_features, options):
        super().__init__()
        out = 1 + options["decoder_output_dim"]
        lr_mul = options["decoder_lr_mul"]
        self.net = _MLP2(n_features, 64, out, lr_mul)
        self.net_semantic = _MLP2(n_features, 64, out, lr_mul)
        self.semantic_sigmoid = options["sigmoid"]

    def forward(self, sampled_features, ray_directions):
        x = sampled_features.mean(dim=1)
        n, m, c = x.shape
        x = x.reshape(n * m, c)
        rgb = self.net(x).reshape(n, m, -1)
        semantic = self.net_semantic(x).reshape(n, m, -1)
        sigma = semantic[..., 0:1]
        rgb = _sigmoid_clamp(rgb[..., 1:])
        semantic = (_sigmoid_clamp(semantic[..., 1:]) if self.semantic_sigmoid
                    else semantic[..., 1:])
        return {"rgb": torch.cat([rgb, semantic], dim=-1), "sigma": sigma}


class Backbone(nn.Module):
    def __init__(self, z_dim, c_dim, w_dim, mapping_kwargs, **synthesis_kwargs):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim=w_dim, img_resolution=256,
                                          img_channels=96, **synthesis_kwargs)
        mk = dict(mapping_kwargs)
        cls = MAPPINGS[mk.pop("class_name").split(".")[-1]]
        self.mapping = cls(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                           num_ws=self.synthesis.num_ws, **mk)


class Generator(nn.Module):
    """forward(z, c, mask, nrr) -> {image, image_raw, image_depth, semantic,
    semantic_raw}, NHWC, as the program's generator returns them (with
    noise_mode 'const' and det=True)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 semantic_channels, sr_num_fp16_res=0, mapping_kwargs=None,
                 rendering_kwargs=None, sr_kwargs=None, data_type=None,
                 class_name=None, **synthesis_kwargs):
        super().__init__()
        if class_name.split(".")[-1] != "TriPlaneSemanticEntangleGenerator":
            raise ValueError(f"the reference holds the shipped generator only, "
                             f"not {class_name}")
        self.z_dim = z_dim
        self.rendering_kwargs = rk = dict(rendering_kwargs)
        self.semantic_channels = semantic_channels
        self.data_type = data_type
        self.backbone = Backbone(z_dim, c_dim, w_dim, mapping_kwargs, **synthesis_kwargs)
        sr_common = dict(channels=32, img_resolution=img_resolution,
                         sr_num_fp16_res=sr_num_fp16_res,
                         sr_antialias=rk["sr_antialias"], **(sr_kwargs or {}))
        self.superresolution = build_superresolution(rk["superresolution_module"],
                                                     **sr_common)
        self.superresolution_semantic = build_superresolution(
            rk["superresolution_module_semantic"], semantic_channels=semantic_channels,
            **sr_common)
        self.decoder = LateSeparateDecoder(
            32, {"decoder_lr_mul": rk.get("decoder_lr_mul", 1),
                 "decoder_output_dim": 32, "sigmoid": semantic_channels == 1})
        self.renderer = ImportanceRenderer()
        self.resample = frustum.Resample()

    def _pose_c(self, c):
        rk = self.rendering_kwargs
        if rk["c_gen_conditioning_zero"]:
            c = torch.zeros_like(c)
        return c * rk.get("c_scale", 0)

    def render(self, planes, c, nrr):
        rk = self.rendering_kwargs
        cam2world, intrinsics = c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3)
        if rk.get("sampler") == "frustum":
            return frustum.frustum_render(planes, self.decoder, self.resample,
                                          cam2world, intrinsics, rk, nrr,
                                          rk["frustum_depth_steps"])
        ray_origins, ray_directions = sample_rays(cam2world, intrinsics, nrr)
        feats, depths, weights = self.renderer(planes, self.decoder, ray_origins,
                                               ray_directions, rk, det=True)
        return feats, depths, weights

    def forward(self, z, c, mask, nrr):
        ws = self.backbone.mapping(z, self._pose_c(c), batch={"mask": mask, "pose": c})
        img = self.backbone.synthesis(ws, noise_mode="const")
        n, _, h, w = img.shape
        planes = img.reshape(n, 3, 32, h, w).permute(0, 1, 3, 4, 2)
        feats, depths, _ = self.render(planes, c, nrr)
        fimg = feats.reshape(n, nrr, nrr, -1).permute(0, 3, 1, 2)
        half = fimg.shape[1] // 2
        rgb_feats, sem_feats = fimg[:, :half], fimg[:, half:]
        rgb, sem = rgb_feats[:, :3], sem_feats[:, :self.semantic_channels]
        mode = self.rendering_kwargs["superresolution_noise_mode"]
        sr_image = self.superresolution(rgb, rgb_feats, ws, noise_mode=mode)
        sr_sem = self.superresolution_semantic(sem, sem_feats, ws, noise_mode=mode)

        def nhwc(x):
            return x.permute(0, 2, 3, 1)

        return {"image": nhwc(sr_image), "image_raw": nhwc(rgb),
                "image_depth": depths.reshape(-1, nrr, nrr, 1),
                "semantic": nhwc(sr_sem), "semantic_raw": nhwc(sem)}
