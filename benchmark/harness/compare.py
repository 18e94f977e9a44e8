"""The comparison that decides `correct`: the program's answers against the
plain reference's, each compared number held to its limit.

For a generator cell a number is named `<output>.<statistic>`, the output
one of image, image_raw, image_depth, semantic, semantic_raw:
- `max`: the largest, over the compared images, of one image's relative L2
  distance ||program - reference|| / ||reference||, which one altered
  answer moves;
- `pooled`: the relative L2 distance of all compared images together, which
  a few outlying images move less.
A non-finite distance (a NaN or an infinity in the program's answer) reads
as infinity and fails.  A cell's limits file names the numbers it compares.
"""

import contextlib
import math

import torch

OUTPUTS = ("image", "image_raw", "image_depth", "semantic", "semantic_raw")


class Worst:
    """Every number of every output over the answers added, the numbers in
    `limits` held to them, with the count of answers that exceeded a `max`
    limit and of those that never came."""

    def __init__(self, limits):
        self.limits = limits
        self.max = {k: 0.0 for k in OUTPUTS}
        self.sq = {k: [0.0, 0.0] for k in OUTPUTS}    # sum of squares: difference, reference
        self.answers = 0
        self.failed = 0
        self.missing = 0

    def add(self, got, want):
        """One block of answers: {output: [n, ...]} of the program and of
        the reference."""
        bad = torch.zeros(want[OUTPUTS[0]].shape[0], dtype=torch.bool)
        for k in OUTPUTS:
            n = want[k].shape[0]
            diff = (got[k].float() - want[k].float()).reshape(n, -1)
            ref = want[k].float().reshape(n, -1)
            d2, r2 = diff.square().sum(dim=1).double(), ref.square().sum(dim=1).double()
            rel = torch.nan_to_num((d2 / r2.clamp_min(1e-60)).sqrt(), nan=math.inf,
                                   posinf=math.inf).cpu()
            self.max[k] = max(self.max[k], float(rel.max()))
            self.sq[k][0] += float(d2.sum())
            self.sq[k][1] += float(r2.sum())
            limit = self.limits.get(f"{k}.max")
            if limit is not None:
                bad |= rel > limit
        self.answers += int(bad.numel())
        self.failed += int(bad.sum())

    @property
    def values(self):
        out = {}
        for k in OUTPUTS:
            out[f"{k}.max"] = self.max[k]
            d2, r2 = self.sq[k]
            pooled = math.sqrt(d2 / r2) if r2 > 0 else math.inf
            out[f"{k}.pooled"] = pooled if math.isfinite(pooled) else math.inf
        return out

    @property
    def correct(self):
        values = self.values
        return self.answers > 0 and not self.missing and all(
            math.isfinite(values[k]) and values[k] <= self.limits[k] for k in self.limits)

    def checks(self):
        values = self.values
        return {k: {"value": values[k], "limit": self.limits[k]} for k in self.limits}


@contextlib.contextmanager
def tf32(on):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Fp8Products(torch.utils._python_dispatch.TorchDispatchMode):
    """Every product and convolution takes its floating-point operands
    rounded to float8 (e4m3, scaled per tensor) and back: the reference one
    precision below bf16."""

    OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                     torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
                     torch.ops.aten.convolution.default, torch.ops.aten.matmul.default})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            args = tuple(_fp8(a) for a in args)
        return func(*args, **(kwargs or {}))


def _fp8(x):
    """x rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude at e4m3's largest, 448), as an fp8 path scales it."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


class control:
    """The control's precision on the reference `model`: one step below what
    the configuration states for each product.  Blocks that the program
    runs in bf16 (modules with `use_fp16` set) take float8 products; every
    other f32 product runs in TF32."""

    def __init__(self, model):
        self.model = model
        self.handles = []

    def __enter__(self):
        self.tf32 = tf32(True)
        self.tf32.__enter__()
        mode = _Fp8Products()

        def enter(*_):
            mode.__enter__()

        def leave(*_):
            mode.__exit__(None, None, None)

        for m in self.model.modules():
            if getattr(m, "use_fp16", False):
                self.handles.append(m.register_forward_pre_hook(enter))
                self.handles.append(m.register_forward_hook(leave))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.tf32.__exit__(*exc)
