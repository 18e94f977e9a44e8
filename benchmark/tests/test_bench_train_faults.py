"""A training run whose step is broken underneath comes out not correct.

The training cell's run is driven at a tiny size on the CPU past the look
for a card (`harness/train.py` `measure`, one window step at index 0, which
runs every phase), with the program's step broken in one of two ways: R1's
gamma halved (both discriminators' regularization), or one phase's update
skipped (D_semantic's main phase computes its gradient and takes no Adam
step).  The sound run passes the same limits, the cell's own."""

import pytest
import torch

from harness import spec, train
import tiny_train

CPU = torch.device("cpu")


def halve_r1_gamma(monkeypatch):
    from pix2pix3d_tpu_torch.train import loss as tloss
    real = tloss.Pix2Pix3DLoss.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.r1_gamma = self.r1_gamma / 2
    monkeypatch.setattr(tloss.Pix2Pix3DLoss, "__init__", init)


class _NoStep:
    def step(self):
        pass


def skip_dsmain_update(monkeypatch):
    from pix2pix3d_tpu_torch.parallel import trainer as ttrainer
    real = ttrainer.Trainer._phase_update

    def update(self, name, loss_fn, module, opt, gain):
        return real(self, name, loss_fn, module, _NoStep() if name == "dsmain" else opt, gain)
    monkeypatch.setattr(ttrainer.Trainer, "_phase_update", update)


# each fault with the steps compared: step 0 runs every phase; step 1 has no
# reg phase, so a skipped D_semantic main update leaves D_semantic unchanged
FAULTS = {"sound": (None, (0,)), "r1_gamma_halved": (halve_r1_gamma, (0,)),
          "dsmain_update_skipped": (skip_dsmain_update, (0, 1))}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_fails_the_run(fault, monkeypatch):
    cell = spec.cell("seg2cat-train")
    patch, steps = FAULTS[fault]
    if patch is not None:
        patch(monkeypatch)
    got = train.measure(cell, 2**31 + 43, 0.01, False, CPU,
                        tiny_train.overrides(cell, steps))["compare"]
    assert got.correct == (fault == "sound"), got.checks()
    if fault != "sound":
        assert got.failed > 0
