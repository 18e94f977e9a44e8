"""Training CLI of the port, mirroring the JAX package's `train.py` flag for
flag (ref `train.py:181-534`), e.g. the seg2cat recipe
(`train_scripts/afhq_seg.sh`):

    python -m pix2pix3d_tpu_torch.train --outdir=runs --cfg=afhq \\
        --data=imgs --mask_data=masks --data_type=seg --batch=4 --gamma=5 \\
        --semantic_channels=6 --render_mask=True --dis_mask=True \\
        --neural_rendering_resolution_initial=128 --gen_pose_cond=True \\
        --random_c_prob=0.5 --lambda_d_semantic=0.1 --lambda_lpips=1 \\
        --lambda_cross_view=1e-4 --only_raw_recons=True

It trains on one card (`--device cuda`, the default; raises without one) or
on the CPU with `--device cpu`.  Every flag of `train.py` runs but
`--num-nodes` above 1 (multi-card training), which raises
`NotImplementedError` naming its ROADMAP item: every generator the flags
select (train.py's defaults `--render_mask False --dis_mask False` train
the conditional EG3D `TriPlaneGenerator` without D_semantic; `--use_bg
True` the background-plane generator, with `--silhouette_loss True` its
silhouette term; any resolution of 128², 256² and 512²), `--aug ada|fixed`
(ADA), `--sampler frustum` (with `--frustum_depth_steps`,
`--frustum_chunk`, `--frustum_bf16`), `--remat True`, and the TensorBoard
event file (always) and wandb (with `PIX2PIX3D_WANDB`).  `--jit_phases` is
accepted and has no effect: the port runs the phases eagerly, one after
another, which is the JAX package's per-phase mode's math
(`train/loop.py:73-81` there).
"""

import argparse
import json
import os
import re

from .. import config as cfg_mod
from .dataset import build_dataset

# the ROADMAP item of multi-card training, not ported yet
TRAINING_ITEM = "ROADMAP.md Queue 1 item 4"


def parse_bool(v):
    return str(v).lower() in ("1", "true", "yes")


def parser():
    p = argparse.ArgumentParser(prog="python -m pix2pix3d_tpu_torch.train")
    p.add_argument("--outdir", required=True)
    p.add_argument("--cfg", required=True,
                   choices=["ffhq", "celeba", "afhq", "shapenet"])
    p.add_argument("--data", required=True)
    p.add_argument("--mask_data", required=True)
    p.add_argument("--data_type", default="seg", choices=["seg", "edge"])
    p.add_argument("--batch", type=int, required=True)
    p.add_argument("--gamma", type=float, required=True)
    p.add_argument("--batch-gpu", dest="batch_gpu", type=int, default=None)
    p.add_argument("--cond", type=parse_bool, default=True)
    p.add_argument("--aug", default="noaug", choices=["noaug", "ada", "fixed"])
    p.add_argument("--target", type=float, default=0.6)
    p.add_argument("--p", type=float, default=0.2)
    p.add_argument("--mirror", type=parse_bool, default=False)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--jit_phases", type=parse_bool, default=False,
                   help="accepted for the JAX CLI's sake; no effect (the "
                        "port runs the phases eagerly)")
    p.add_argument("--resume_partial", type=parse_bool, default=False)
    p.add_argument("--cbase", type=int, default=32768)
    p.add_argument("--cmax", type=int, default=512)
    p.add_argument("--glr", type=float, default=None)
    p.add_argument("--dlr", type=float, default=0.002)
    p.add_argument("--map-depth", dest="map_depth", type=int, default=2)
    p.add_argument("--mbstd-group", dest="mbstd_group", type=int, default=4)
    p.add_argument("--kimg", type=float, default=25000)
    p.add_argument("--tick", type=float, default=4)
    p.add_argument("--snap", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_resolution", type=int, default=0)
    p.add_argument("--neural_rendering_resolution_initial", type=int, default=64)
    p.add_argument("--neural_rendering_resolution_final", type=int, default=None)
    p.add_argument("--neural_rendering_resolution_fade_kimg", type=int, default=1000)
    p.add_argument("--blur_fade_kimg", type=int, default=200)
    p.add_argument("--gen_pose_cond", type=parse_bool, default=False)
    p.add_argument("--c-scale", dest="c_scale", type=float, default=1.0)
    p.add_argument("--gpc_reg_prob", type=float, default=0.5)
    p.add_argument("--gpc_reg_fade_kimg", type=int, default=1000)
    p.add_argument("--disc_c_noise", type=float, default=0)
    p.add_argument("--sr_noise_mode", default="none", choices=["random", "none"])
    p.add_argument("--resume_blur", type=parse_bool, default=False)
    p.add_argument("--sr_num_fp16_res", type=int, default=4)
    p.add_argument("--g_num_fp16_res", type=int, default=0)
    p.add_argument("--d_num_fp16_res", type=int, default=4)
    p.add_argument("--density_reg", type=float, default=0.25)
    p.add_argument("--density_reg_every", type=int, default=4)
    p.add_argument("--density_reg_p_dist", type=float, default=0.004)
    p.add_argument("--reg_type", default="l1",
                   choices=["l1", "l1-alt", "monotonic-detach",
                            "monotonic-fixed", "total-variation"])
    p.add_argument("--decoder_lr_mul", type=float, default=1.0)
    p.add_argument("--random_c_prob", type=float, default=0)
    p.add_argument("--render_mask", type=parse_bool, default=False)
    p.add_argument("--dis_mask", type=parse_bool, default=False)
    p.add_argument("--lambda_l1", type=float, default=0)
    p.add_argument("--lambda_lpips", type=float, default=10)
    p.add_argument("--lambda_d_semantic", type=float, default=1)
    p.add_argument("--seg_weight", type=float, default=0)
    p.add_argument("--edge_weight", type=float, default=2)
    p.add_argument("--only_raw_recons", type=parse_bool, default=False)
    p.add_argument("--semantic_channels", type=int, default=19)
    p.add_argument("--use_bg", type=parse_bool, default=False)
    p.add_argument("--silhouette_loss", type=parse_bool, default=False)
    p.add_argument("--geometry_layer", type=int, default=7)
    p.add_argument("--lambda_cross_view", type=float, default=0)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--point_chunk", type=int, default=0,
                   help="renderer field-eval chunk (points); 0 = renderer default")
    p.add_argument("--sampler", default="gather", choices=["gather", "frustum"])
    p.add_argument("--frustum_depth_steps", type=int, default=96)
    p.add_argument("--frustum_chunk", type=int, default=8)
    p.add_argument("--frustum_bf16", type=parse_bool, default=True)
    p.add_argument("--remat", type=parse_bool, default=False)
    p.add_argument("--num-nodes", dest="num_nodes", type=int, default=1)
    p.add_argument("--node-rank", dest="node_rank", type=int, default=None)
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    p.add_argument("-n", "--dry-run", dest="dry_run", action="store_true")
    return p


def check_deferred(args):
    """Refuse the flags of parts of the JAX trainer not ported yet."""
    if args.num_nodes > 1:
        raise NotImplementedError("--num-nodes > 1 (multi-card training) is not "
                                  f"ported yet: {TRAINING_ITEM}")


def run_config(args):
    """The `training_loop` kwargs for parsed `args` (JAX `train.py:165-259`)."""
    resolution = args.data_resolution or None
    probe = build_dataset(args.data, args.mask_data, data_type=args.data_type,
                          resolution=resolution, use_labels=args.cond)
    resolution = probe.resolution
    probe.close()

    g_config = cfg_mod.generator_config(
        cfg=args.cfg, resolution=resolution, data_type=args.data_type,
        semantic_channels=args.semantic_channels, map_depth=args.map_depth,
        cbase=args.cbase, cmax=args.cmax, sr_num_fp16_res=args.sr_num_fp16_res,
        g_num_fp16_res=args.g_num_fp16_res, render_mask=args.render_mask,
        use_bg=args.use_bg, geometry_layer=args.geometry_layer,
        gen_pose_cond=args.gen_pose_cond, gpc_reg_prob=args.gpc_reg_prob,
        c_scale=args.c_scale, sr_noise_mode=args.sr_noise_mode,
        density_reg=args.density_reg,
        density_reg_p_dist=args.density_reg_p_dist, reg_type=args.reg_type,
        decoder_lr_mul=args.decoder_lr_mul)
    if args.point_chunk:
        g_config["rendering_kwargs"]["point_chunk"] = args.point_chunk
    if args.sampler == "frustum":
        g_config["rendering_kwargs"]["sampler"] = "frustum"
        g_config["rendering_kwargs"]["frustum_depth_steps"] = args.frustum_depth_steps
        g_config["rendering_kwargs"]["frustum_chunk"] = args.frustum_chunk
        g_config["rendering_kwargs"]["frustum_bf16"] = args.frustum_bf16

    blur_init = 10 if (args.resume is None or args.resume_blur) else 0
    gpc_fade = (args.gpc_reg_fade_kimg if (args.resume is None or args.resume_blur)
                else 0)
    loss_kwargs = dict(
        r1_gamma=args.gamma,
        blur_init_sigma=blur_init,
        blur_fade_kimg=args.batch * args.blur_fade_kimg / 32,
        neural_rendering_resolution_initial=args.neural_rendering_resolution_initial,
        neural_rendering_resolution_final=args.neural_rendering_resolution_final,
        neural_rendering_resolution_fade_kimg=args.neural_rendering_resolution_fade_kimg,
        gpc_reg_prob=args.gpc_reg_prob if args.gen_pose_cond else None,
        gpc_reg_fade_kimg=gpc_fade,
        dual_discrimination=True,
        random_c_prob=args.random_c_prob,
        lambda_l1=args.lambda_l1,
        lambda_lpips=args.lambda_lpips,
        lambda_D_semantic=args.lambda_d_semantic,
        seg_weight=args.seg_weight,
        edge_weight=args.edge_weight,
        only_raw_recons=args.only_raw_recons,
        silhouette_loss=args.silhouette_loss,
        lambda_cross_view=args.lambda_cross_view,
        remat=args.remat,
    )
    d_kwargs = dict(channel_base=args.cbase, channel_max=args.cmax,
                    num_fp16_res=args.d_num_fp16_res,
                    conv_clamp=256 if args.d_num_fp16_res > 0 else None,
                    disc_c_noise=args.disc_c_noise,
                    epilogue_kwargs=dict(mbstd_group_size=args.mbstd_group))
    return dict(
        dataset_kwargs=dict(path=args.data, mask_path=args.mask_data,
                            data_type=args.data_type,
                            resolution=args.data_resolution or None,
                            use_labels=args.cond, xflip=args.mirror),
        g_config=g_config, d_kwargs=d_kwargs, loss_kwargs=loss_kwargs,
        use_d_semantic=args.dis_mask,
        g_lr=args.glr if args.glr is not None else 0.0025,
        d_lr=args.dlr,
        g_reg_interval=args.density_reg_every if args.density_reg > 0 else None,
        augment_kwargs=(None if args.aug == "noaug" else dict(
            xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
            brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)),
        augment_p=(args.p if args.aug == "fixed" else 0.0),
        ada_target=(args.target if args.aug == "ada" else None),
        batch_size=args.batch, batch_gpu=args.batch_gpu,
        total_kimg=args.kimg, kimg_per_tick=args.tick,
        snapshot_ticks=args.snap, image_snapshot_ticks=args.snap,
        random_seed=args.seed, resume_path=args.resume,
        resume_partial=args.resume_partial,
        jit_phases=args.jit_phases,
        lpips_weights=args.lpips_weights,
        device=args.device,
    )


def main(argv=None, step_fn=None):
    """Parse `argv` (default: the command line), train, return the run
    directory.  `step_fn` is handed to `training_loop` (instrumentation)."""
    args = parser().parse_args(argv)
    check_deferred(args)
    config = run_config(args)

    desc = (f"{args.cfg}-{os.path.basename(args.data).split('.')[0]}"
            f"-batch{args.batch}-gamma{args.gamma:g}")
    existing = [int(m.group(1)) for d in (os.listdir(args.outdir)
                if os.path.isdir(args.outdir) else [])
                if (m := re.match(r"^(\d+)-", d))]
    run_dir = os.path.join(args.outdir, f"{max(existing, default=-1) + 1:05d}-{desc}")

    print(json.dumps({k: str(v) for k, v in config.items()}, indent=2))
    if args.dry_run:
        print("Dry run; exiting.")
        return run_dir
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump({k: str(v) for k, v in config.items()}, f, indent=2)

    from .loop import training_loop
    training_loop(run_dir=run_dir, step_fn=step_fn, **config)
    return run_dir


if __name__ == "__main__":
    main()
