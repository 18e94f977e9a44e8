"""The port's spans (`utils/profiling.py`): `annotate` costs no range
outside a profiler and opens one inside it; `host_read` is the counted host
sync; the frustum render's `render.prepare` and `render.slabs` spans nest
and count as the benchmark's readers expect, and the render reads nothing
back to the host; the render's outputs do not change under the profiler; the
generator's stages keep their names.

Port only, on the CPU, at tiny sizes: nothing here compares with JAX.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator
from pix2pix3d_tpu_torch.models.triplane import (STAGES, OSGDecoderSemanticLateSeparate,
                                                 init_parameters)
from pix2pix3d_tpu_torch.ops.decode_composite import fuse_late_separate_params_t
from pix2pix3d_tpu_torch.render import camera as tcam
from pix2pix3d_tpu_torch.render import frustum as tfr
from pix2pix3d_tpu_torch.render.camera import pose_to_conditioning
from pix2pix3d_tpu_torch.utils import profiling

CPU = [ProfilerActivity.CPU]
OPTS = {"ray_start": 2.25, "ray_end": 3.3, "box_warp": 1.0,
        "depth_resolution": 24, "depth_resolution_importance": 24,
        "white_back": False}
N, S, NRR, T, CHUNK = 2, 64, 16, 24, 8
# both cover every tap of the camera below (tests/test_torch_render.py)
WINDOW, TILES = (192, 192), (4, 96, 4, 96, 256)


def _names(prof):
    return [e.name for e in prof.events()]


def test_annotate_opens_a_range_only_under_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profiling.annotate("off"):
        pass
    assert profiling.annotate("a") is profiling.annotate("b")   # one shared no-op
    assert profiling.host_read(torch.arange(3), "test") == [0, 1, 2]
    monkeypatch.undo()

    with profile(activities=CPU) as prof:
        with profiling.annotate("on"):
            torch.ones(4) * 2
        got = profiling.host_read(torch.arange(3) * 2, "test")
    assert got == [0, 2, 4]
    names = _names(prof)
    assert names.count("on") == 1 and names.count("sync.test") == 1
    with profiling.annotate("after"):
        pass                      # the profiler is gone: no range, no error


def _render_inputs(fused):
    gen = torch.Generator().manual_seed(0)
    # smooth planes, as a backbone gives: bicubic up from an 8x8 grid
    base = torch.randn(N * 3, 32, S // 8, S // 8, generator=gen)
    planes = torch.nn.functional.interpolate(base, size=(S, S), mode="bicubic",
                                             align_corners=False)
    planes = planes.reshape(N, 3, 32, S, S).permute(0, 1, 3, 4, 2).contiguous()
    dec = OSGDecoderSemanticLateSeparate(32, {"decoder_output_dim": 32,
                                              "decoder_lr_mul": 1.0, "sigmoid": False})
    init_parameters(dec, gen)
    dec.eval()
    c2w = tcam.LookAtPoseSampler.sample(math.pi / 2 + 0.2, math.pi / 2 - 0.1,
                                        [0.0, 0.0, -0.06], radius=2.7, batch_size=N,
                                        device="cpu")
    intr = tcam.fov_to_intrinsics(18.837, device="cpu")[None].expand(N, 3, 3)
    fused_dec = ((*fuse_late_separate_params_t(dec, dec.lr_mul), False)
                 if fused else None)
    return planes, dec, c2w, intr, fused_dec


def _render(fused, tiles):
    planes, dec, c2w, intr, fused_dec = _render_inputs(fused)
    with torch.no_grad():
        return tfr.frustum_render(planes, dec, c2w, intr, OPTS, NRR, depth_steps=T,
                                  chunk=CHUNK, window=None if tiles else WINDOW,
                                  tiles=tiles, fused_decoder=fused_dec)


def _within(e, name):
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


CASES = pytest.mark.parametrize("fused,tiles", [(False, None), (False, TILES),
                                                (True, None), (True, TILES)])


@CASES
def test_render_spans_count_and_nest(fused, tiles):
    """With a window or with tiles the render reads nothing back (no
    `sync.*` span); one `render.slabs` span a chunk, one `render.prepare`."""
    with profile(activities=CPU) as prof:
        _render(fused, tiles)
    events = prof.events()
    assert _names(prof).count("render.slabs") == T // CHUNK
    assert _names(prof).count("render.prepare") == 1
    assert {e.name for e in events if e.name.startswith("sync.")} == set()


@CASES
def test_render_outputs_are_the_same_under_the_profiler(fused, tiles):
    plain = _render(fused, tiles)
    with profile(activities=CPU):
        traced = _render(fused, tiles)
    for a, b in zip(plain, traced):
        assert not torch.isnan(a).any()
        assert torch.equal(a, b)


def _small_generator():
    cfg = tconfig.generator_config(
        cfg="afhq", resolution=128, data_type="seg", semantic_channels=6,
        cbase=1024, cmax=32, sr_num_fp16_res=0, render_mask=True,
        gen_pose_cond=True)
    cfg["mapping_kwargs"]["in_resolution"] = 128
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    cfg["rendering_kwargs"].update(sampler="frustum", frustum_depth_steps=48,
                                   frustum_chunk=16, frustum_bf16=False,
                                   frustum_window=(384, 448), decoder_impl="kernel")
    return build_generator(device="cpu", **cfg)


def test_generator_stages_keep_their_names():
    """The benchmark reads the stage ranges by name; the render's spans lie
    inside `render`."""
    G = _small_generator()
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(1, 512, generator=gen)
    mask = torch.randint(0, 6, (1, 128, 128, 1), generator=gen).float()
    c2w = tcam.LookAtPoseSampler.sample(math.pi / 2, math.pi / 2, [0.0, 0.0, -0.06],
                                        radius=2.7, device="cpu")
    pose = pose_to_conditioning(c2w, tcam.fov_to_intrinsics(18.837, device="cpu"))
    with torch.no_grad(), profile(activities=CPU) as prof:
        G(z, pose, {"mask": mask, "pose": pose}, neural_rendering_resolution=32,
          noise_mode="const")
    names = _names(prof)
    for stage in STAGES:
        assert names.count(stage) == 1, stage
    events = prof.events()
    inner = [e for e in events if e.name in ("render.prepare", "render.slabs",
                                             "sync.window")]
    assert [e.name for e in inner].count("render.slabs") == 48 // 16
    assert [e.name for e in inner].count("sync.window") == 0    # the window path
    assert all(_within(e, "render") for e in inner)
