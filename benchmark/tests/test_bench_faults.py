"""A run whose timed path is broken underneath comes out not correct.

Each cell's run is driven at a tiny size on the CPU past the look for a
card, with the program's generator broken in one of the ways a generator
cell can be: one image's answer altered where it is produced (its rendered
features halved), or half of the batch left out (the first half computed
and its answers handed out for the rest).  The sound run passes the same
limits."""

import pytest
import torch

from harness import generate, spec
import tiny

CPU = torch.device("cpu")
CELLS = ["seg2cat-batch32", "edge2car-batch32", "seg2cat-serve-b1"]


def break_render(monkeypatch):
    from pix2pix3d_tpu_torch.models import triplane
    real = triplane._TriPlaneBase._render_planes

    def altered(self, *args, **kwargs):
        feats, *rest = real(self, *args, **kwargs)
        feats = feats.clone()
        feats[0] = feats[0] * 0.5
        return (feats, *rest)
    monkeypatch.setattr(triplane._TriPlaneBase, "_render_planes", altered)


def drop_half_batch(monkeypatch):
    from pix2pix3d_tpu_torch.models import triplane
    real = triplane._TriPlaneBase.forward

    def half(self, z, c, batch, **kwargs):
        h = max(z.shape[0] // 2, 1)
        out = real(self, z[:h], c[:h], {k: v[:h] for k, v in batch.items()}, **kwargs)
        reps = -(-z.shape[0] // h)
        return {k: torch.cat([v] * reps)[:z.shape[0]] for k, v in out.items()}
    monkeypatch.setattr(triplane._TriPlaneBase, "forward", half)


FAULTS = {"sound": None, "answer_altered": break_render, "half_batch_left_out": drop_half_batch}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails_the_run(name, fault, monkeypatch):
    cell = spec.cell(name)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    ov = tiny.overrides(name)
    ov["traffic"]["warmup_units"] = 0
    got = generate.measure(cell, 2**31 + 41, 0.01, False, CPU, ov)["compare"]
    assert got.correct == (fault == "sound"), got.checks()
    if fault != "sound":
        assert got.failed > 0
