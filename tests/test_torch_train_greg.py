"""The port's density regularization (`g_reg`) against the JAX package's,
value and gradient: 'l1' on the recipe's settings, and 'monotonic-detach'
(front-behind monotonicity plus the l1 term), at the setting and tolerances
of tests/test_torch_train_phases.py (its helpers): loss 1e-4 relative;
per-leaf gradient max |g - g_jax| <= 1e-3 max |g_jax| + 1e-6.  The draws
(points, directions, perturbation, the backbone's noise) are JAX's, handed
to the port's hooks in the order JAX drew them.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import jax
import pytest
import torch

from pix2pix3d_tpu import config as jconfig
from pix2pix3d_tpu.models import build_generator as jbuild
from pix2pix3d_tpu.train.loss import Pix2Pix3DLoss as JLoss

from pix2pix3d_tpu_torch import bridge
from pix2pix3d_tpu_torch import config as tconfig
from pix2pix3d_tpu_torch.models import build_generator as tbuild
from pix2pix3d_tpu_torch.train import loss as tloss

from test_torch_train_phases import (assert_grads_close, assert_loss_close,
                                     _jb, jit_with_draws, LOSS_KW, make_batch,
                                     port_value_and_grad, shared_draws,
                                     tiny_cfg, to_torch, two_torch_threads)

__all__ = ["shared_draws", "two_torch_threads"]


@pytest.mark.parametrize("reg_type", ["l1", "monotonic-detach"])
def test_g_reg(shared_draws, reg_type):
    """Density regularization: 'l1' on the recipe's settings, and
    'monotonic-detach' (front-behind monotonicity + the l1 term)."""
    G = jbuild(**tiny_cfg(jconfig, reg_type))
    L = JLoss(G, None, lpips=None, **LOSS_KW)
    tG = tbuild(device="cpu", train=True, seed=3, **tiny_cfg(tconfig, reg_type))
    params = bridge.params_to_jax(tG)
    batch, gen_z, _ = make_batch(1)
    fn = jit_with_draws(lambda pg, b, z, key: jax.value_and_grad(
        lambda p: L.g_reg(p, b, z, key), has_aux=True)(pg))
    ((value, _), grads), draws = fn(params, _jb(batch), gen_z[1], jax.random.PRNGKey(7))
    tG.load_state_dict(bridge.params_from_jax(params), strict=True)
    tL = tloss.Pix2Pix3DLoss(tG, None, lpips=None, **LOSS_KW)
    shared_draws.extend(draws)
    got, _, tgrads = port_value_and_grad(
        lambda: tL.g_reg(to_torch(batch), torch.from_numpy(gen_z[1]), torch.Generator()),
        tG, [tG])
    assert float(value) > 0
    assert_loss_close(got, value)
    assert_grads_close(tgrads, grads, reg_type)
