"""The port against the JAX package on trained weights: the tree's
`docs/ckpts_r5/seg2cat128_r5_ema.ckpt` (seg2cat at 128², the
`SuperresolutionHybrid2X` pair, step 8000, every leaf stored as bf16),
built through both packages' `build_app_generator`, one `generate_sample`
each on the importance sampler and on the frustum sampler (96 depth steps).

The run is f32: the checkpoint's sidecar is copied with `sr_num_fp16_res` 0
and `frustum_bf16` False (they pick compute types only; the weights are
the same), and both generators read the bf16 leaves widened to f32.
Tolerance 1e-4: the port's tests' gate for each path (the renderer's,
tests/test_parity_render.py, and tests/test_torch_generator.py's).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import json
import os
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pix2pix3d_tpu.apps import common as jcommon
from pix2pix3d_tpu.apps import generate_samples as jsamples
from pix2pix3d_tpu.render import camera as jcam

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch.apps import common as tcommon
from pix2pix3d_tpu_torch.apps import generate_samples as tsamples
from pix2pix3d_tpu_torch.utils.misc import tree_paths

R5 = Path(__file__).resolve().parent.parent / "docs" / "ckpts_r5" / "seg2cat128_r5_ema.ckpt"
OUTPUTS = ("image", "image_raw", "image_depth", "semantic", "semantic_raw")


@pytest.fixture(scope="module")
def r5(tmp_path_factory):
    d = tmp_path_factory.mktemp("r5")
    ckpt = str(d / "r5.ckpt")
    os.symlink(R5, ckpt)
    meta = json.loads(Path(str(R5) + ".json").read_text())
    meta["g_config"]["sr_num_fp16_res"] = 0
    meta["g_config"]["rendering_kwargs"]["frustum_bf16"] = False
    Path(ckpt + ".json").write_text(json.dumps(meta))
    G, params, app = jcommon.build_app_generator("seg2cat", checkpoint=ckpt)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    Gt, tapp = tcommon.build_app_generator("seg2cat", checkpoint=ckpt, device="cpu")
    assert tapp == app and app["neural_rendering_resolution"] == 64
    return G, params, Gt, app


def test_r5_weights_load_as_in_jax(r5):
    _, params, Gt, _ = r5
    got = dict(tree_paths(bridge.params_to_jax(Gt)))
    want = dict(tree_paths(jax.device_get(params)))
    assert set(got) == set(want) and len(got) == 214
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("sampler", ["importance", "frustum"])
def test_r5_generate_sample_matches_jax(r5, sampler):
    G, params, Gt, app = r5
    for g in (G, Gt):
        g.rendering_kwargs.pop("sampler", None)
        if sampler == "frustum":
            g.rendering_kwargs["sampler"] = "frustum"
    rng = np.random.RandomState(0)
    z = rng.randn(1, 512).astype(np.float32)
    mask = rng.randint(0, 6, (128, 128, 1)).astype(np.float32)
    c2w = jcam.LookAtPoseSampler.sample(None, np.pi / 2 + 0.2, np.pi / 2 - 0.1,
                                        [0, 0, -0.06], radius=2.7)
    pose = np.array(jcam.pose_to_conditioning(c2w, jcommon.intrinsics_for(app)))[0]
    want = jsamples.generate_sample(G, params, app, mask, pose, z=jnp.asarray(z))
    got = tsamples.generate_sample(Gt, app, mask, pose, z=z)
    for key in OUTPUTS:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
