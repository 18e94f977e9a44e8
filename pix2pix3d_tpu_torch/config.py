"""Configuration presets (a copy of `pix2pix3d_tpu/config.py`).

The port keeps its own copy so that it imports nothing of the JAX package.
`preset_generator_config(name)` builds the kwargs of a released model
(seg2cat, seg2face, edge2car);
`serving_generator_config("seg2cat")` adds the serving settings of
`docs/serving_default.json` and `bench.py` (frustum sampler, fused decode+composite, 64 depth slabs in
chunks of 8, f32 composite carry, bf16 tensors in 7 backbone/encoder
resolutions, semantic SR at f32 activations).
"""

from __future__ import annotations

import copy


# Rendering presets per dataset config (ref train.py:425-461).
RENDERING_PRESETS = {
    "ffhq": dict(depth_resolution=48, depth_resolution_importance=48,
                 ray_start=2.25, ray_end=3.3, box_warp=1,
                 avg_camera_radius=2.7, avg_camera_pivot=[0, 0, 0.2]),
    "celeba": dict(depth_resolution=48, depth_resolution_importance=48,
                   ray_start=2.25, ray_end=3.3, box_warp=1,
                   avg_camera_radius=2.7, avg_camera_pivot=[0, 0, 0.2]),
    "afhq": dict(depth_resolution=48, depth_resolution_importance=48,
                 ray_start=2.25, ray_end=3.3, box_warp=1,
                 avg_camera_radius=2.7, avg_camera_pivot=[0, 0, -0.06]),
    "shapenet": dict(depth_resolution=64, depth_resolution_importance=64,
                     ray_start=0.1, ray_end=2.6, box_warp=1.6, white_back=True,
                     avg_camera_radius=1.7, avg_camera_pivot=[0, 0, 0]),
}

# SR module selection by output resolution (ref train.py:389-399).
SR_MODULES = {
    512: ("SuperresolutionHybrid8XDC", "SuperresolutionHybrid8XDC_semantic"),
    256: ("SuperresolutionHybrid4X", "SuperresolutionHybrid4X_semantic"),
    128: ("SuperresolutionHybrid2X", "SuperresolutionHybrid2X_semantic"),
}


def rendering_kwargs(cfg, resolution, gen_pose_cond=False, gpc_reg_prob=0.5,
                     c_scale=1.0, sr_noise_mode="none", density_reg=0.25,
                     density_reg_p_dist=0.004, reg_type="l1", decoder_lr_mul=1.0,
                     sr_module=None):
    """Full rendering_kwargs dict (ref train.py:401-461)."""
    sr, sr_sem = SR_MODULES[resolution]
    if sr_module is not None:
        sr = sr_module
    rk = dict(
        image_resolution=resolution,
        disparity_space_sampling=False,
        clamp_mode="softplus",
        superresolution_module=sr,
        superresolution_module_semantic=sr_sem,
        c_gen_conditioning_zero=not gen_pose_cond,
        gpc_reg_prob=gpc_reg_prob if gen_pose_cond else None,
        c_scale=c_scale,
        superresolution_noise_mode=sr_noise_mode,
        density_reg=density_reg,
        density_reg_p_dist=density_reg_p_dist,
        reg_type=reg_type,
        decoder_lr_mul=decoder_lr_mul,
        sr_antialias=True,
    )
    rk.update(RENDERING_PRESETS[cfg])
    return rk


def generator_config(cfg="afhq", resolution=512, data_type="seg",
                     semantic_channels=6, z_dim=512, w_dim=512, c_dim=25,
                     map_depth=2, cbase=32768, cmax=512, sr_num_fp16_res=4,
                     g_num_fp16_res=0, render_mask=True, use_bg=False,
                     geometry_layer=7, gen_pose_cond=False, **rk_overrides):
    """Build the kwargs for `models.build_generator` for a training config
    (ref train.py:343-409,374-380,505-512)."""
    mapping_class = {
        "seg": "MaskMappingNetwork_disentangle",
        "edge": "EdgeMappingNetwork_disentangle",
    }[data_type]
    in_channels = semantic_channels if data_type == "seg" else 1

    class_name = "TriPlaneGenerator"
    if render_mask:
        class_name = ("TriPlaneSemanticEntangleGenerator_withBG" if use_bg
                      else "TriPlaneSemanticEntangleGenerator")

    rk = rendering_kwargs(cfg, resolution, gen_pose_cond=gen_pose_cond,
                          **rk_overrides)
    return dict(
        class_name=class_name,
        z_dim=z_dim,
        c_dim=c_dim,
        w_dim=w_dim,
        img_resolution=resolution,
        img_channels=3,
        semantic_channels=semantic_channels,
        sr_num_fp16_res=sr_num_fp16_res,
        mapping_kwargs=dict(class_name=mapping_class, num_layers=map_depth,
                            in_resolution=resolution, in_channels=in_channels,
                            geometry_layer=geometry_layer),
        rendering_kwargs=rk,
        sr_kwargs=dict(channel_base=cbase, channel_max=cmax),
        data_type=data_type,
        channel_base=cbase,
        channel_max=cmax,
        num_fp16_res=g_num_fp16_res,
        conv_clamp=256 if g_num_fp16_res > 0 else None,
    )


# The three released-model configurations (ref train_scripts/*.sh).
PRESETS = {
    "seg2cat": dict(cfg="afhq", resolution=512, data_type="seg",
                    semantic_channels=6, gen_pose_cond=True),
    "seg2face": dict(cfg="celeba", resolution=512, data_type="seg",
                     semantic_channels=19, gen_pose_cond=True),
    "edge2car": dict(cfg="shapenet", resolution=128, data_type="edge",
                     semantic_channels=1, geometry_layer=9, gen_pose_cond=True),
}


def preset_generator_config(name, **overrides):
    kw = copy.deepcopy(PRESETS[name])
    kw.update(overrides)
    return generator_config(**kw)


# Serving settings (docs/serving_default.json, bench.py:60-99).
SERVING_G_NUM_FP16_RES = 7
SERVING_RENDERING = dict(
    sampler="frustum",
    decoder_impl="kernel",
    frustum_depth_steps=64,
    frustum_chunk=8,
    fused_carry_f32=True,
    sr_sem_precision="default",
)
SERVING_NEURAL_RENDERING_RESOLUTION = 128


def serving_generator_config(name="seg2cat", **overrides):
    """`preset_generator_config(name, **overrides)` with the serving
    overrides applied (e.g. `use_bg=True`: the background generator)."""
    cfg = preset_generator_config(name, sr_num_fp16_res=4,
                                  g_num_fp16_res=SERVING_G_NUM_FP16_RES, **overrides)
    cfg["mapping_kwargs"]["encoder_num_fp16_res"] = SERVING_G_NUM_FP16_RES
    cfg["rendering_kwargs"].update(SERVING_RENDERING)
    return cfg
