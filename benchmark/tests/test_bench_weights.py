"""The weights drawn on the device follow the models' own init rule: what
the port's `init_parameters` fills with a constant the harness fills with
the same constant, and what it draws the harness draws at the same scale.
One seed gives the program's generator and the reference the same values."""

import copy

import pytest
import torch

from harness import generate, weights
from tiny import TINY_GENERATOR

CPU = torch.device("cpu")


def tiny_kwargs(config):
    from harness.spec import cell
    conf = cell({"seg2cat": "seg2cat-batch32", "edge2car": "edge2car-batch32"}[config])["config"]
    return generate._merge(conf["generator"], TINY_GENERATOR)


@pytest.mark.parametrize("config", ["seg2cat", "edge2car"])
def test_rule_matches_the_ports_init(config):
    from pix2pix3d_tpu_torch.models.triplane import GENERATOR_REGISTRY, init_parameters
    kw = tiny_kwargs(config)
    cls = GENERATOR_REGISTRY[kw.pop("class_name")]
    G = cls(**copy.deepcopy(kw))
    init_parameters(G, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in G.state_dict().items()}
    plan = weights._plan(G)
    planned = {name for name, *_ in plan}
    for name, t, scale, const in plan:
        port = state[name]
        if scale is None:
            assert torch.all(port == const), name
        elif port.numel() >= 256:
            assert port.std().item() == pytest.approx(scale, rel=0.15), name
    # whatever the rule leaves alone, the port's init leaves as constructed
    fresh = cls(**copy.deepcopy(kw)).state_dict()
    for name, v in fresh.items():
        if name not in planned:
            assert torch.equal(state[name], v), name


def test_same_seed_same_weights_in_program_and_reference():
    kw = tiny_kwargs("seg2cat")
    G = generate.program_generator(kw, 2**31 + 5, CPU)
    R = generate.reference_generator(kw, 2**31 + 5, CPU)
    sg, sr = G.state_dict(), R.state_dict()
    assert set(sg) == set(sr)
    for k in sg:
        assert torch.equal(sg[k], sr[k]), k
    G2 = generate.program_generator(kw, 7, CPU)
    assert not torch.equal(G2.state_dict()["decoder.net.fc0.weight"], sg["decoder.net.fc0.weight"])
