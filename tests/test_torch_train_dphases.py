"""The port's discriminator phases (`d_main`, `d_r1`, `d_semantic_main`,
`d_semantic_r1`) against the JAX package's, value and gradient, at the
setting and tolerances of tests/test_torch_train_phases.py (its helpers):
loss 1e-4 relative; per-leaf gradient max |g - g_jax| <= 1e-3 max |g_jax|
+ 1e-6 (summation orders differ, and R1's double backward amplifies them).
The D phases render the fake images under `torch.no_grad`, as JAX's under
`stop_gradient`; `d_main` also returns the ws for the w_avg update.
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import numpy as np
import pytest
import torch

from test_torch_train_phases import (assert_grads_close, assert_loss_close,
                                     BLUR, coin_key, jax_phase_fns, _jb,
                                     make_batch, Nets, NRR,
                                     port_value_and_grad, shared_draws,
                                     to_torch, two_torch_threads)

__all__ = ["shared_draws", "two_torch_threads"]


@pytest.fixture(scope="module")
def setup():
    nets = Nets()
    batch, gen_z, gen_c = make_batch()
    return nets, jax_phase_fns(nets), batch, gen_z, gen_c


@pytest.mark.parametrize("phase", ["dmain", "dreg", "dsmain", "dsreg"])
def test_discriminator_phases(setup, shared_draws, phase):
    nets, fns, batch, gen_z, gen_c = setup
    P = nets.params
    key = coin_key(1.0 if phase == "dsmain" else 0.0, start=300)
    tb = to_torch(batch)
    gen = torch.Generator()
    L = nets.tloss
    if phase == "dmain":
        ((value, (stats, aux)), grads), draws = fns["dmain"](
            P["D"], P["G"], _jb(batch), gen_z[2], gen_c[2], key)
        fn = lambda: L.d_main(tb, torch.from_numpy(gen_z[2]),
                              torch.from_numpy(gen_c[2]), gen, BLUR, NRR)
        module = nets.tD
    elif phase == "dreg":
        ((value, stats), grads), draws = fns["dreg"](P["D"], _jb(batch), key)
        fn = lambda: L.d_r1(tb, gen, BLUR, NRR)
        module = nets.tD
    elif phase == "dsmain":
        ((value, stats), grads), draws = fns["dsmain"](
            P["D_semantic"], P["G"], _jb(batch), gen_z[3], gen_c[3], key)
        fn = lambda: L.d_semantic_main(tb, torch.from_numpy(gen_z[3]),
                                       torch.from_numpy(gen_c[3]), gen, BLUR, NRR)
        module = nets.tDs
    else:
        ((value, stats), grads), draws = fns["dsreg"](P["D_semantic"], _jb(batch), key)
        fn = lambda: L.d_semantic_r1(tb, gen, BLUR, NRR)
        module = nets.tDs
    shared_draws.extend(draws)
    got, taux, tgrads = port_value_and_grad(fn, module, list(nets.modules().values()))
    assert_loss_close(got, value)
    if phase == "dmain":
        tstats, tws = taux
        np.testing.assert_allclose(tws["ws"].numpy(), np.asarray(aux["ws"]),
                                   rtol=1e-4, atol=1e-5)
    assert_grads_close(tgrads, grads, phase)
