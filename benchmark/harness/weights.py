"""Seeded weights, drawn on the device.

The rule is the models' own init (the StyleGAN2 layers' `reset_parameters`):
every parameter is N(0, 1) divided by its layer's `lr_multiplier`, but for
biases (their layer's `bias_init`, else 0) and noise strengths (0); of the
buffers, the constant noise inputs `noise_const` are N(0, 1), and the rest
(filters, `w_avg`) keep what the constructor made.  The draws come from one
`torch.Generator` on the device in a single call, in the order of the
tensors' names, so two models with the same names and shapes (the program's
generator and the plain reference) get the same values from a seed.
"""

from __future__ import annotations

import torch

_DRAWN_BUFFERS = ("noise_const",)


def _plan(model):
    """[(name, tensor, scale or None, constant)] in name order: scale for a
    drawn tensor, constant for a filled one."""
    plan = []
    for prefix, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            if name == "bias":
                plan.append((full, p, None, float(getattr(mod, "bias_init", 0.0))))
            elif name == "noise_strength":
                plan.append((full, p, None, 0.0))
            else:
                plan.append((full, p, 1.0 / float(getattr(mod, "lr_multiplier", 1.0)),
                             None))
        for name, b in mod.named_buffers(recurse=False):
            if name in _DRAWN_BUFFERS:
                full = f"{prefix}.{name}" if prefix else name
                plan.append((full, b, 1.0, None))
    plan.sort(key=lambda e: e[0])
    return plan


@torch.no_grad()
def draw(model, seed, device):
    """Fill `model`'s parameters (and drawn buffers) from `seed`, on `device`
    (the model's own): one normal draw of all drawn elements."""
    plan = _plan(model)
    total = sum(t.numel() for _, t, scale, _ in plan if scale is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    at = 0
    for _, t, scale, const in plan:
        if scale is None:
            t.fill_(const)
            continue
        n = t.numel()
        t.copy_(flat[at:at + n].view(t.shape).mul_(scale))
        at += n
    return total
