"""Where the served dual SR pass rounds to bf16, in the port and in JAX.

As served (`sr_num_fp16_res` 4: bf16 SR blocks), each package's grouped
pass (`dual_superresolution`) differs from its own two separate stacks by
bf16 rounding.  The port's must be no further from its separate stacks than
JAX's is from its own, by more than one bf16 step at the outputs' largest
magnitude: a port that rounded the grouped pass in other places (the
per-group demodulation, the cast of the concatenated input) would be.

The test runs the 2X pair at 32 channels (tests/test_torch_variants.py's
setup, noise strengths 0.1, const noise).  Run as a script, this file makes
the same comparison at full seg2cat width on the CPU: the serving
generator's 8XDC pair, random weights from seed 0 bridged to JAX, fed the
SR inputs (rgb and semantic images, feature images, ws) of one request of
the port's serving generator; it prints each package's dual-vs-separate
distance, its share of tests/test_dual_sr.py's bf16 allclose (rtol = atol =
2e-2), the f32 distances and the packages' distance from each other:

    PYTHONPATH=. python tests/test_torch_dual_sr_served.py
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import math
import sys

import numpy as np
import torch

import jax

from pix2pix3d_tpu.nn import superresolution as jsr

from pix2pix3d_tpu_torch.nn import superresolution as tsr

from test_torch_variants import _dual_setup, _nchw

DUAL_BF16_TOL = 2e-2


def bf16_step(scale):
    """One bf16 rounding step (8 significant bits) at magnitude `scale`."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def allclose_share(got, want, tol=DUAL_BF16_TOL):
    return float((np.abs(got - want) / (tol * (1 + np.abs(want)))).max())


def jax_pair(jr, js, p_rgb, p_sem, arrays, ws, noise_mode, fp32=False):
    """JAX's (separate rgb, separate semantic, dual rgb, dual semantic), NHWC."""
    def separate(p_a, p_b, rgb, x_rgb, sem, x_sem, w):
        return (jr(p_a, rgb, x_rgb, w, noise_mode=noise_mode, force_fp32=fp32),
                js(p_b, sem, x_sem, w, noise_mode=noise_mode, force_fp32=fp32))

    def dual(*args):
        return jsr.dual_superresolution(jr, js, *args, noise_mode=noise_mode,
                                        force_fp32=fp32)
    args = (p_rgb, p_sem, *arrays, ws)
    return [np.asarray(a, np.float32) for a in (*jax.jit(separate)(*args),
                                                *jax.jit(dual)(*args))]


def port_pair(tr, ts, arrays, ws, noise_mode, fp32=False):
    """The port's (separate rgb, separate semantic, dual rgb, dual semantic),
    NHWC."""
    rgb, x_rgb, sem, x_sem = (_nchw(a) for a in arrays)
    ws = torch.from_numpy(ws)
    with torch.no_grad():
        outs = (tr(rgb, x_rgb, ws, noise_mode=noise_mode, force_fp32=fp32),
                ts(sem, x_sem, ws, noise_mode=noise_mode, force_fp32=fp32),
                *tsr.dual_superresolution(tr, ts, rgb, x_rgb, sem, x_sem, ws,
                                          noise_mode=noise_mode, force_fp32=fp32))
    return [o.float().permute(0, 2, 3, 1).numpy() for o in outs]


def test_dual_pass_rounds_where_jax_rounds():
    (jr, js, p_rgb, p_sem), (tr, ts), arrays, ws = _dual_setup(6, fp16=4)
    want = jax_pair(jr, js, p_rgb, p_sem, arrays, ws, "const")
    got = port_pair(tr, ts, arrays, ws, "const")
    for i in range(2):
        jax_apart = np.abs(want[2 + i] - want[i]).max()
        port_apart = np.abs(got[2 + i] - got[i]).max()
        assert port_apart <= jax_apart + bf16_step(np.abs(want[i]).max()), i


def main():
    """The full-width comparison (see the module docstring)."""
    from pix2pix3d_tpu import config as jconfig
    from pix2pix3d_tpu.models import build_generator as jbuild
    from pix2pix3d_tpu_torch import bridge
    from pix2pix3d_tpu_torch import config as tconfig
    from pix2pix3d_tpu_torch.models import build_generator as tbuild
    from pix2pix3d_tpu_torch.render.camera import (LookAtPoseSampler, fov_to_intrinsics,
                                                   pose_to_conditioning)

    cfg = tconfig.serving_generator_config("seg2cat")
    cfg["rendering_kwargs"].pop("sr_sem_precision")     # it takes priority over dual_sr
    G = tbuild(device="cpu", seed=0, **cfg)
    gen = torch.Generator().manual_seed(12)
    z = torch.randn((1, G.z_dim), generator=gen)
    mask = torch.randint(0, 6, (1, 512, 512, 1), generator=gen).float()
    c2w = LookAtPoseSampler.sample(math.pi / 2, math.pi / 2, [0, 0, -0.06], radius=2.7,
                                   device="cpu")
    pose = pose_to_conditioning(c2w, fov_to_intrinsics(18.837, device="cpu"))
    inputs = {}

    def keep(name):
        def hook(module, args, kwargs):
            inputs[name] = [a.float().permute(0, 2, 3, 1).numpy() if a.ndim == 4
                            else a.numpy() for a in args[:3]]
        return hook
    G.superresolution.register_forward_pre_hook(keep("rgb"), with_kwargs=True)
    G.superresolution_semantic.register_forward_pre_hook(keep("sem"), with_kwargs=True)
    with torch.no_grad():
        G(z, pose, {"mask": mask, "pose": pose}, neural_rendering_resolution=128,
          noise_mode="const")
    (rgb, x_rgb, ws), (sem, x_sem, _) = inputs["rgb"], inputs["sem"]
    arrays = [rgb, x_rgb, sem, x_sem]
    params = bridge.params_to_jax(G)
    JG = jbuild(**jconfig.preset_generator_config("seg2cat", sr_num_fp16_res=4,
                                                  g_num_fp16_res=7))
    sr = (JG.superresolution, JG.superresolution_semantic,
          params["superresolution"], params["superresolution_semantic"])
    res = {}
    for fp32 in (False, True):
        res["jax", fp32] = jax_pair(*sr, arrays, ws, "const", fp32)
        res["port", fp32] = port_pair(G.superresolution, G.superresolution_semantic,
                                      arrays, ws, "const", fp32)
    for fp32 in (False, True):
        blocks = "f32 blocks" if fp32 else "bf16 blocks (served)"
        for pkg in ("jax", "port"):
            sep_r, sep_s, dual_r, dual_s = res[pkg, fp32]
            for name, d, s in (("image", dual_r, sep_r), ("semantic", dual_s, sep_s)):
                print(f"{blocks}, {pkg:4s} {name:8s}: dual vs separate max abs "
                      f"{np.abs(d - s).max():.3e}, {allclose_share(d, s):.3f} of the "
                      f"2e-2 allclose; largest |separate| {np.abs(s).max():.3f}, one "
                      f"bf16 step there {bf16_step(np.abs(s).max()):.3e}")
        for i, name in enumerate(("separate image", "separate semantic",
                                  "dual image", "dual semantic")):
            print(f"{blocks}, port vs jax {name}: max abs "
                  f"{np.abs(res['port', fp32][i] - res['jax', fp32][i]).max():.3e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(8)
    sys.exit(main())
