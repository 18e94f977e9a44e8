"""The port's whole seg2cat-type generator against the JAX package's, and the
rules that keep the port a port.

The generator runs at the small configuration of
tests/test_render_pallas.py::test_generator_fused_frustum_path (afhq, 128^2,
cbase 1024, cmax 32, encoder_channel_base 1/128, sr_num_fp16_res 0, nrr 32,
48 depth slabs in chunks of 16, f32 render) with weights bridged from
`G.init(PRNGKey(0))`, the JAX side through its Pallas kernel (interpreter)
and the port's through `fused_decode_composite` (its plain version on the
CPU).  Tolerance 1e-4: all five outputs are f32 on both sides; the JAX
suite's own end-to-end parity gates are 2e-3..5e-3 (tests/test_parity_e2e.py).
"""

import ast
import inspect
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.render.camera import (LookAtPoseSampler, fov_to_intrinsics,
                                         pose_to_conditioning)

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.apps.common import (APP_PRESETS, build_app_generator,
                                             intrinsics_for)
from pix2pix3d_tpu_torch.apps.generate_video import orbit_poses
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.ops import decode_composite as dc
from pix2pix3d_tpu_torch.render import camera as tcam

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pix2pix3d_tpu_torch"
OUTPUTS = ("image", "image_raw", "image_depth", "semantic", "semantic_raw")


def _small_cfg(cfg_mod):
    cfg = cfg_mod.generator_config(
        cfg="afhq", resolution=128, data_type="seg", semantic_channels=6,
        cbase=1024, cmax=32, sr_num_fp16_res=0, render_mask=True,
        gen_pose_cond=True)
    cfg["mapping_kwargs"]["in_resolution"] = 128
    cfg["mapping_kwargs"]["encoder_channel_base"] = 1 / 128
    cfg["rendering_kwargs"].update(sampler="frustum", frustum_depth_steps=48,
                                   frustum_chunk=16, frustum_bf16=False)
    return cfg


@pytest.fixture(scope="module")
def generators():
    G = jbuild(**_small_cfg(jconfig))
    G.rendering_kwargs["decoder_impl"] = "pallas"
    params = jax.jit(G.init)(jax.random.PRNGKey(0))
    Gt = tbuild(device="cpu", **_small_cfg(tconfig))
    Gt.rendering_kwargs["decoder_impl"] = "kernel"
    Gt.load_state_dict(bridge.params_from_jax(jax.device_get(params)), strict=True)
    return G, params, Gt


def _request(yaw, pitch, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(1, 512).astype(np.float32)
    mask = rng.randint(0, 6, (1, 128, 128, 1)).astype(np.float32)
    c2w = LookAtPoseSampler.sample(None, yaw, pitch, [0.0, 0.0, -0.06], radius=2.7)
    pose = np.array(pose_to_conditioning(c2w, fov_to_intrinsics(18.837)))
    return z, mask, pose


@pytest.mark.parametrize("yaw,pitch,seed", [(np.pi / 2 + 0.15, np.pi / 2 - 0.1, 0),
                                            (np.pi / 2 - 0.3, np.pi / 2 + 0.2, 1)])
def test_generator_outputs_match_jax(generators, yaw, pitch, seed):
    G, params, Gt = generators
    z, mask, pose = _request(yaw, pitch, seed)
    want = G(params, jnp.asarray(z), jnp.asarray(pose),
             {"mask": jnp.asarray(mask), "pose": jnp.asarray(pose)},
             neural_rendering_resolution=32, noise_mode="const", det=True)
    before = dc.fused_decode_composite.launches
    with torch.no_grad():
        got = Gt(torch.from_numpy(z), torch.from_numpy(pose),
                 {"mask": torch.from_numpy(mask), "pose": torch.from_numpy(pose)},
                 neural_rendering_resolution=32, noise_mode="const")
    assert dc.fused_decode_composite.launches == before   # CPU: plain version
    for key in OUTPUTS:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_bridge_covers_every_parameter(generators):
    """Every JAX leaf lands on a port parameter or buffer of the same size,
    and nothing of the port's state is left out."""
    _, params, Gt = generators
    sd = bridge.params_from_jax(jax.device_get(params))
    own = Gt.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    leaves = jax.tree_util.tree_leaves(params)
    assert sum(np.asarray(a).size for a in leaves) == sum(v.numel() for v in sd.values())


def test_serving_config_matches_the_jax_serving_settings():
    cfg = tconfig.serving_generator_config("seg2cat")
    ref = jconfig.preset_generator_config("seg2cat", sr_num_fp16_res=4,
                                          g_num_fp16_res=7)
    rk = cfg.pop("rendering_kwargs")
    rk_ref = ref.pop("rendering_kwargs")
    assert cfg["mapping_kwargs"].pop("encoder_num_fp16_res") == 7
    assert cfg == ref
    for k in ("sampler", "decoder_impl", "frustum_depth_steps", "frustum_chunk",
              "fused_carry_f32", "sr_sem_precision"):
        rk_ref.pop(k, None)
        rk.pop(k)
    assert rk == rk_ref


# --- rules that keep the port a port -------------------------------------

def _port_sources():
    files = [ROOT / "chip_smoke.py"]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        files += [Path(dirpath) / f for f in filenames if f.endswith(".py")]
    return files


def _imports(path, module_level=False):
    """Absolute imports of `path`; with `module_level`, only those outside
    function bodies (run when the module is imported)."""
    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            inside = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if not (module_level and inside):
                if isinstance(child, ast.Import):
                    yield from (a.name for a in child.names)
                elif isinstance(child, ast.ImportFrom) and child.level == 0:
                    yield child.module
            yield from walk(child, inside)
    yield from walk(ast.parse(path.read_text(), filename=str(path)), False)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    banned = ("jax", "jaxlib", "flax", "msgpack", "pix2pix3d_tpu")
    found = [(str(p.relative_to(ROOT)), m) for p in _port_sources()
             for m in _imports(p) if m.split(".")[0] in banned]
    assert not found, found
    assert len(_port_sources()) > 20


def test_import_rules_cover_the_trainer():
    """The trainer's modules, its CLI, every module of the metrics package
    and the profiling helpers are among the sources the two import checks
    read."""
    sources = set(_port_sources())
    for name in ("trainer", "loss", "loop", "dataset", "native_loader", "lpips",
                 "stats", "ema", "checkpoint", "viz", "__main__", "augment", "tb",
                 "wandb_sink"):
        assert PORT / "train" / f"{name}.py" in sources, name
    for name in ("png", "profiling"):
        assert PORT / "utils" / f"{name}.py" in sources, name
    for name in ("metric_utils", "frechet_inception_distance", "miou", "inception",
                 "kernel_inception_distance", "precision_recall", "inception_score",
                 "perceptual_path_length", "metric_main"):
        assert PORT / "metrics" / f"{name}.py" in sources, name


def test_port_imports_pil_only_inside_functions():
    """The card's machine has no Pillow: the port imports PIL only where an
    image is read or written, inside a function, as the JAX apps do."""
    found = [str(p.relative_to(ROOT)) for p in _port_sources()
             for m in _imports(p, module_level=True) if m.split(".")[0] == "PIL"]
    assert not found, found
    inside = [p for p in _port_sources()
              if any(m.split(".")[0] == "PIL" for m in _imports(p))]
    assert len(inside) >= 3   # the apps and train/viz.py do import it


def test_port_carries_no_weight_or_binary_files():
    suffixes = {".so", ".npz", ".npy", ".pt", ".pth", ".ckpt", ".pkl", ".bin"}
    found = [str(p) for dirpath, dirnames, files in os.walk(PORT)
             for p in (Path(dirpath) / f for f in files)
             if "_build" not in p.parts and p.suffix in suffixes]
    assert not found, found
    src = " ".join(p.read_text() for p in _port_sources())
    assert "ckpts_r5" not in src


def test_public_entry_defaults_to_the_card():
    entries = {tbuild: lambda: tbuild(**_small_cfg(tconfig)),
               build_app_generator: lambda: build_app_generator("seg2cat"),
               intrinsics_for: lambda: intrinsics_for(APP_PRESETS["seg2cat"]),
               orbit_poses: lambda: orbit_poses(APP_PRESETS["seg2cat"], 2),
               tcam.LookAtPoseSampler.sample:
                   lambda: tcam.LookAtPoseSampler.sample(0.0, 0.0, [0, 0, 0]),
               tcam.fov_to_intrinsics: lambda: tcam.fov_to_intrinsics(18.837)}
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    for call in entries.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_wrapper_raises_on_cuda_requests_it_cannot_serve():
    """No fallback: a CUDA request the kernel cannot take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    args = [torch.randn((2, 1, 4, 32, 64), generator=g).cuda(),
            torch.rand((1, 8)).cuda() + 2, torch.ones((1, 64)).cuda(),
            torch.randn((128, 32)).cuda(), torch.zeros((128, 1)).cuda(),
            torch.randn((128, 128)).cuda(), torch.zeros((128, 1)).cuda()]
    bad_dtype = [args[0].half()] + args[1:]
    with pytest.raises(TypeError):
        dc.fused_decode_composite(*bad_dtype)
    mixed = args[:3] + [args[3].cpu()] + args[4:]
    with pytest.raises(ValueError):
        dc.fused_decode_composite(*mixed)
    strided = [args[0].transpose(3, 4).contiguous().transpose(3, 4)] + args[1:]
    with pytest.raises(ValueError):
        dc.fused_decode_composite(*strided)
