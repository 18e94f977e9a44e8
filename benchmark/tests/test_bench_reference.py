"""The plain reference against today's program at a tiny width on the CPU,
f32 on both sides: the serving path (frustum sampler, the fused
decode+composite kernel's plain version on the CPU) and the apps' importance
path.  Both compute the same model, so all five outputs agree to f32
rounding (the frustum's windowed contraction and the reference's full one
add the same taps)."""

import pytest
import torch

from harness import compare, generate, spec
import tiny

CPU = torch.device("cpu")
TOL = 1e-5


@pytest.mark.parametrize("name", ["seg2cat-batch32", "edge2car-batch32"])
def test_reference_matches_the_program(name):
    cell = spec.cell(name)
    run = generate.GenerateCell(cell, 2**31 + 77, CPU, tiny.overrides(name))
    with torch.no_grad():
        z, c, mask = run.requests.unit(0)
        got = run.G(z, c, {"mask": mask, "pose": c}, neural_rendering_resolution=run.nrr,
                    noise_mode="const", det=True)
        ref = generate.reference_generator(run.gkw, run.seed, CPU)
        want = ref(z, c, mask, run.nrr)
    for key in compare.OUTPUTS:
        assert got[key].shape == want[key].shape, key
    worst = compare.Worst({})
    worst.add(got, want)
    assert len(worst.values) == 2 * len(compare.OUTPUTS)
    for number, value in worst.values.items():
        assert value < TOL, number
