"""StyleGAN3 on the port's normal path against the benchmark's plain
reference (`benchmark/reference/nn/stylegan3.py`), on the CPU at 32^2 with 5
layers: `build_generator("GeneratorS3")`, the spans and the call counter
the benchmark's readers count, the lazy import of scipy, the roofline's
work function (`benchmark/harness/filtered_lrelu_work.py`) by hand, and
the `latent` traffic kind (`benchmark/harness/latent.py`) end to end, a seeded
fault included.

Port only: nothing here compares with JAX (tests/test_torch_stylegan3.py
does).
"""

import torch_cpu  # noqa: F401  (thread and heap settings: tests/torch_cpu.py)
import copy
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import filtered_lrelu_work, latent, spec, weights  # noqa: E402
from reference.nn import stylegan3 as rs3  # noqa: E402

from pix2pix3d_tpu_torch.models import build_generator  # noqa: E402
from pix2pix3d_tpu_torch.nn import stylegan3 as ts3  # noqa: E402
from pix2pix3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu  # noqa: E402

CELL = "stylegan3-t-batch32"
# chip_smoke.py phase 30's small T and R: 32^2, 5 layers, f32
SMALL = dict(z_dim=64, c_dim=0, w_dim=64, img_resolution=32, img_channels=3,
             mapping_kwargs={"num_layers": 2}, num_layers=5, num_fp16_res=0,
             conv_clamp=256)
KINDS = {"T": dict(channel_base=1024, channel_max=32),
         "R": dict(channel_base=2048, channel_max=64, conv_kernel=1,
                   use_radial_filters=True)}
# the port against the reference, both f32 on the CPU: the same math in
# another form (the port scales the input channels around one shared-weight
# convolution, the reference builds per-sample weights; the filters are
# designed twice) reads ~1e-7 relative L2, while bf16 in the port's layers
# (8 mantissa bits, ~4e-3 a rounding) reads above 1e-3
TOL = 1e-4


def kwargs(kind, **over):
    return dict(SMALL, **KINDS[kind], **over)


def generators(kind, seed=3, **over):
    """(port, reference) of `kind` at the small size, the same weights."""
    kw = kwargs(kind, **over)
    G = build_generator("GeneratorS3", device="cpu", **kw)
    R = rs3.GeneratorS3(**kw).eval().requires_grad_(False)
    for model in (G, R):
        weights.draw(model, seed, torch.device("cpu"))
        latent.draw_input(model, seed, torch.device("cpu"))
    return G, R


def rel_l2(got, want):
    return float((got - want).norm() / want.norm())


def z_batch(n=2, seed=7):
    return torch.randn((n, SMALL["z_dim"]), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_matches_the_reference(kind):
    G, R = generators(kind)
    z, c = z_batch(), torch.zeros(2, 0)
    with torch.no_grad():
        got, want = G(z, c), R(z, c)
    assert got.shape == want.shape == (2, 3, 32, 32)
    assert rel_l2(got, want) <= TOL


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_layers_fail_the_tolerance(kind):
    # num_fp16_res 4 marks every layer of a 32^2 network (sampling rate x 16 > 32)
    G, R = generators(kind, num_fp16_res=4)
    assert all(getattr(G.synthesis, n).use_fp16 for n in G.synthesis.layer_names)
    z, c = z_batch(), torch.zeros(2, 0)
    with torch.no_grad():
        got, want = G(z, c), R(z, c)
    assert rel_l2(got, want) > 10 * TOL


def test_build_generator_builds_it_with_the_references_names_and_shapes():
    kw = kwargs("T")
    G = build_generator("GeneratorS3", device="cpu", seed=1, **kw)
    assert isinstance(G, ts3.GeneratorS3) and not G.training
    assert not any(p.requires_grad for p in G.parameters())
    R = rs3.GeneratorS3(**kw)
    for named in ("named_parameters", "named_buffers"):
        got = {k: tuple(v.shape) for k, v in getattr(G, named)()}
        want = {k: tuple(v.shape) for k, v in getattr(R, named)()}
        assert got == want, named
    assert G.synthesis.layer_names == R.synthesis.layer_names
    assert [getattr(G.synthesis, n).use_fp16 for n in G.synthesis.layer_names] == \
        [getattr(R.synthesis, n).use_fp16 for n in R.synthesis.layer_names]


def test_a_forward_opens_one_span_of_each_per_layer_and_counts_its_calls():
    G, _ = generators("T")
    layers = SMALL["num_layers"] + 1
    before = filtered_lrelu.calls
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        G(z_batch(), torch.zeros(2, 0))
    names = [e.name for e in prof.events()]
    assert filtered_lrelu.calls - before == layers
    assert names.count("modconv") == names.count("filtered_lrelu") == layers
    assert [names.count(n) for n in ("mapping", "synthesis", "synthesis_input")] == [1, 1, 1]


def test_importing_the_triplane_module_loads_no_scipy():
    code = ("import sys, pix2pix3d_tpu_torch.models.triplane\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'scipy'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def published_t():
    return filtered_lrelu_work.reference_on_meta(spec.cell(CELL)["config"]["generator"])


def test_the_work_of_one_layer_by_hand():
    syn = published_t().synthesis
    n = 32
    # L10: x [n, 144, 278, 278] bf16 (the 3x3 conv of 276^2 with a 2-pixel
    # pad), up 4 with 24 taps and padding -6/-9 -> 1074^2, down 2 with 12
    # taps -> 532^2; each up pass 24 / 4 = 6 taps an output, each down pass 12
    mid = 278 * 4 - 6 - 9 - 24 + 1
    assert mid == 1074
    want_bytes = 2 * (n * 144 * 278 * 278 + 144 + n * 144 * 532 * 532)
    want_flops = 2 * n * 144 * ((278 * 1074 + 1074 * 1074) * 6 + (1074 * 532 + 532 * 532) * 12)
    assert filtered_lrelu_work.layer_work(syn.L10_532_144, n) == (want_bytes, want_flops)
    # L0: f32, up 2 with 12 taps and padding 9/8: 38 -> 82 -> 36
    want_bytes = 4 * (n * 512 * 38 * 38 + 512 + n * 512 * 36 * 36)
    want_flops = 2 * n * 512 * ((38 * 82 + 82 * 82) * 6 + (82 * 36 + 36 * 36) * 12)
    assert filtered_lrelu_work.layer_work(syn.L0_36_512, n) == (want_bytes, want_flops)
    # ToRGB: no filters, bytes only
    assert filtered_lrelu_work.layer_work(syn.L14_512_3, n) == (
        2 * (n * 3 * 512 * 512 + 3 + n * 3 * 512 * 512), 0)


def test_a_radial_down_filter_counts_its_taps_squared():
    with torch.device("meta"):
        R = rs3.GeneratorS3(**kwargs("R"))
    layer = R.synthesis.L0_36_64
    assert layer.down_radial and layer.down_filter.ndim == 2
    side, out, c, t = 36, 36, layer.out_channels, layer.down_taps
    mid = side * 2 + sum(layer.padding[:2]) - layer.up_taps + 1
    want = 2 * c * ((side * mid + mid * mid) * (layer.up_taps // 2) + out * out * t * t)
    assert filtered_lrelu_work.layer_work(layer, 1)[1] == want


def tiny_overrides():
    gen = dict(kwargs("T"), class_name="GeneratorS3")
    return {"config": {"generator": gen},
            "traffic": {"batch": 2, "units": 4, "warmup_units": 1, "trace_units": 1,
                        "tf32": False, "compare": {"units": 1, "among": 2, "block": 2}}}


def test_the_latent_cell_runs_and_compares():
    cell = spec.cell(CELL)
    assert cell["traffic"]["kind"] == "latent"
    out = latent.measure(cell, 2**31 + 11, 0.2, True, torch.device("cpu"),
                         overrides=tiny_overrides())
    worst = out["compare"]
    assert worst.correct and worst.failed == 0 and worst.answers == 2
    assert set(worst.checks()) == set(cell["limits"]["numbers"])
    assert out["window"].units >= 1 and out["unit_images"] == 2
    assert out["trace"].range_count("filtered_lrelu") == SMALL["num_layers"] + 1
    # the reference's products, its FIR convolutions left out, plus the
    # polyphase operations of the work function
    R = filtered_lrelu_work.reference_on_meta(out["gkw"])
    fir = filtered_lrelu_work.work(R.synthesis, 2)[1]
    assert 0 < fir < out["flops_per_unit"]


def test_a_seeded_fault_fails_the_comparison(monkeypatch):
    """The first layer's down-FIR skipped (its filter replaced by a centred
    unit tap of the same length): the cell's limits fail it, as they fail
    it at the published widths on the card."""
    cell = spec.cell(CELL)
    seen = []

    def faulty(x, **kw):
        seen.append(1)
        if len(seen) % (SMALL["num_layers"] + 1) == 1:
            fd = torch.zeros_like(kw["fd"])
            fd[fd.shape[0] // 2] = 1.0
            kw = dict(kw, fd=fd)
        return filtered_lrelu(x, **kw)

    monkeypatch.setattr(ts3, "filtered_lrelu", faulty)
    out = latent.measure(cell, 5, 0.1, False, torch.device("cpu"),
                         overrides=tiny_overrides())
    worst = out["compare"]
    assert not worst.correct
    limits = cell["limits"]["numbers"]
    assert any(worst.values[k] > v for k, v in limits.items())


def test_the_cell_draws_its_inputs_from_the_seed():
    cell = spec.cell(CELL)
    over = tiny_overrides()
    a = latent.LatentCell(cell, 9, torch.device("cpu"), copy.deepcopy(over))
    b = latent.LatentCell(cell, 9, torch.device("cpu"), copy.deepcopy(over))
    c = latent.LatentCell(cell, 10, torch.device("cpu"), copy.deepcopy(over))
    assert torch.equal(a.z, b.z) and not torch.equal(a.z, c.z)
    inp = a.G.synthesis.input
    assert torch.equal(inp.freqs, b.G.synthesis.input.freqs)
    assert torch.equal(inp.affine.bias, torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert not inp.affine.weight.any()
    assert float(inp.phases.min()) >= -0.5 and float(inp.phases.max()) < 0.5
