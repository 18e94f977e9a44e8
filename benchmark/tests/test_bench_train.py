"""The plain training step (`reference/train_step.py`) against the program's
`Trainer.step` at a tiny width on the CPU: one step at index 0, which runs
every phase (the cross-view renders, Gmain, Greg, Dmain with the w_avg
update, Dreg, D_semantic main and reg, the EMA), taken through the training
cell's own path (`harness/train.py`: the loader, `StepInputs`, the step's
clones) and through the reference from the clones.

Tolerances, each with its reason: both sides compute in f32 on the CPU with
the same operations in the same order (the reference's layers are frozen
copies of the program's, and every block runs in f32 at this size), so
- the draws are identical: the same calls, shapes and numbers;
- every stat's [count, sum, sum of squares]: 1e-5 relative (a summation
  order of PyTorch's CPU reductions may differ between two calls);
- each network's first Adam moment (its last phase's gradient) and each
  network's change over the step: 1e-4 relative L2 (a gradient sums many
  products; Adam divides by the square root of the second moment, so an
  entry's rounding moves its update by as much again).
"""

import contextlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from harness import spec, train
import tiny_train

CPU = torch.device("cpu")
STAT_RTOL = 1e-5
L2_TOL = 1e-4


class RecordDraws(TorchFunctionMode):
    """Every `torch.rand`/`torch.randn` call that takes a generator: (name,
    shape, the numbers drawn)."""

    def __init__(self):
        super().__init__()
        self.draws = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (torch.rand, torch.randn) and kwargs.get("generator") is not None:
            self.draws.append((func.__name__, tuple(out.shape), out.detach().clone()))
        return out


@pytest.fixture(scope="module")
def sides():
    """(program, reference) of step 0: draws, stats, state, first moments;
    and the state before the step."""
    from pix2pix3d_tpu_torch.ops import precision
    cell = spec.cell("seg2cat-train")
    with precision.policy(False):
        run = train.TrainCell(cell, 2**31 + 99, CPU, tiny_train.overrides(cell))
        try:
            program = RecordDraws()
            with program:
                run.step()
            snap = run.snapshots[0]
            nets, step = run.reference()
            reference = RecordDraws()
            with reference:
                want = run._reference_step(nets, step, 0, snap)
            want["reg"] = run._reg_probe(nets, step, 0, snap)
        finally:
            run.free_program()
            run.close()
    # the first draw is the loop's latents (`StepInputs`), then the step's own
    assert program.draws[0][:2] == ("randn", (4, run.batch, 512))
    got = dict(snap["program"], draws=program.draws[1:])
    want = dict(want, draws=reference.draws)
    return got, want, snap["before"]


def test_the_draws_are_identical(sides):
    got, want, _ = sides
    assert len(got["draws"]) > 20            # noise, jitter, coins, density points
    assert [d[:2] for d in got["draws"]] == [d[:2] for d in want["draws"]]
    for g, w in zip(got["draws"], want["draws"]):
        assert torch.equal(g[2], w[2]), g[:2]


def test_every_phase_loss(sides):
    got, want, _ = sides
    assert sorted(got["stats"]) == sorted(want["stats"])
    for phase_loss in ("Loss/G/loss", "Loss/D/loss", "Loss/D/reg", "Loss/D/loss_semantic",
                       "Loss/D/reg_semantic", "Loss/G/loss_cross_view"):
        assert phase_loss in want["stats"]
    for name, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name], w, rtol=STAT_RTOL, atol=0, err_msg=name)


def _rel_l2(got, want, base=None):
    d2, r2 = train._dist(got, want, base)
    return math.sqrt(d2 / r2)


def test_the_r1_phases_from_the_programs_state(sides):
    """The reference's R1 phases from D and D_semantic before them (their
    states after the step with the last Adam update taken back) give the
    program's R1 stats: the update is undone to one rounding of each
    parameter."""
    got, want, _ = sides
    assert sorted(want["reg"]) == sorted(n for names in train.REG_PHASES.values()
                                         for n in names)
    for name, w in want["reg"].items():
        np.testing.assert_allclose(got["stats"][name], w, rtol=STAT_RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("net", train.NETS)
def test_every_gradient(sides, net):
    got, want, _ = sides
    assert _rel_l2(got["mu"][net], want["mu"][net]) < L2_TOL


@pytest.mark.parametrize("net", train.STATE_NETS)
def test_every_parameter_change(sides, net):
    got, want, before = sides
    assert _rel_l2(got["state"][net], want["state"][net], before[net]) < L2_TOL


def test_the_cell_is_found_by_name():
    cell = spec.cell("seg2cat-train")
    assert cell["traffic"]["kind"] == "train" and callable(train.measure)
    assert cell["workload"]["chips"] == 1
    numbers = {f"{n}.{s}" for n in train.NUMBERS for s in ("max", "pooled")}
    assert cell["limits"]["numbers"] and set(cell["limits"]["numbers"]) <= numbers
    assert {m["name"] for m in cell["per_layer"]} == {
        "idle_share.train", "mfu.train", "gmain_ms.train", "d_ms.train", "data_ms.train",
        "host_syncs.train"}
    assert {m["name"] for m in cell["end_to_end"]} == {"images_per_s", "setup_s"}
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_the_data_is_drawn_from_the_seed(tmp_path):
    cell = spec.cell("seg2cat-train")
    data = dict(cell["traffic"]["data"], images=3, resolution=32, blobs=4)
    runs = [train.write_dataset(tmp_path / f"r{i}", seed, data, cell["config"]["camera"])
            for i, seed in enumerate((2**31 + 5, 2**31 + 5, 2**31 + 6))]

    def read(dirs):
        return [p.read_bytes() for d in dirs for p in sorted(Path(d).iterdir())]
    assert read(runs[0]) == read(runs[1]) != read(runs[2])
    assert train.loop_seed(2**32 + 7) == 7


def test_the_configuration_is_the_clis(tmp_path):
    """The committed configuration is what the CLI's `run_config` makes of
    its flags, and a file that says otherwise is refused."""
    from pix2pix3d_tpu_torch.train import __main__ as cli
    cell = spec.cell("seg2cat-train")
    conf = cell["config"]
    data = dict(cell["traffic"]["data"], images=2)
    images, masks = train.write_dataset(tmp_path / "d", 1, data, conf["camera"])
    argv = ["--outdir", str(tmp_path / "runs"), "--data", images, "--mask_data", masks,
            "--device", "cpu"] + conf["flags"]
    rc = cli.run_config(cli.parser().parse_args(argv))
    train.check_run_config(rc, conf)
    wrong = dict(conf, loss=dict(conf["loss"], r1_gamma=10.0))
    with pytest.raises(ValueError, match="r1_gamma"):
        train.check_run_config(rc, wrong)


def test_the_control_takes_float8_in_the_bf16_blocks_backward_too():
    """`ControlNets` quantizes the products of a `use_fp16` block in its
    forward and in its backward (the program runs both in bf16), and leaves
    the other blocks' products alone (in f32 on the CPU, where TF32 does
    nothing)."""
    from harness import compare
    torch.manual_seed(0)
    low = torch.nn.Conv2d(4, 8, 3)
    low.use_fp16 = True
    net = torch.nn.Sequential(low, torch.nn.Conv2d(8, 2, 3))
    x = torch.randn(2, 4, 12, 12, requires_grad=True)

    def run(ctx):
        with ctx:
            y = net(x)
            gx, = torch.autograd.grad(y.square().sum(), x)
        return y.detach(), gx

    y32, g32 = run(contextlib.nullcontext())
    y_fwd, g_fwd = run(compare.control(net))          # the forward's products only
    y_ctl, g_ctl = run(train.ControlNets({"net": net}))
    assert torch.equal(y_ctl, y_fwd) and not torch.equal(y_ctl, y32)
    assert not torch.allclose(g_ctl, g_fwd, rtol=1e-3, atol=0)
    assert _rel_l2({"g": g_ctl}, {"g": g32}) < 0.5
    plain = torch.nn.Sequential(torch.nn.Conv2d(4, 2, 3))
    x2 = torch.randn(1, 4, 6, 6)
    with train.ControlNets({"net": plain}):
        y = plain(x2)
    assert torch.equal(y, plain(x2))
