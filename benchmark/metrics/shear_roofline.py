"""The texture-shear kernel's share of its roofline (%): the least time of a
batch's shears over the kernel's device time a batch, the kernel found by
name.

The least time is bytes over the memory rate (harness/counters.py
`bound_s`): the tri-planes read once, f32 as the backbone hands them to the
render (its synthesis output is f32 whatever the blocks' precision), and
the N*3 sheared textures [ext, C, ext], ext = S + 2*128, written once in the
render's compute dtype (bf16 unless `frustum_bf16` is off).  The kernel's
16 taps an output are ~0.03 FLOP a byte, far below the card's balance, so
bytes bound it.  A program without the kernel (before it existed, or a run
whose render took the differentiable shears) has nothing to read: None.
"""

from harness import counters

SHEAR_KERNEL = "cubic_shear_textures"   # csrc/shear_textures.cu
# the tri-plane generator's planes: 3 planes of 32 channels at 256^2
# (models/triplane.py, the backbone), and the shears' margin on each side
PLANES, CHANNELS, PLANE_RES, MARGIN = 3, 32, 256, 128


def read(ctx):
    if ctx.trace is None:
        return None
    kernel_s = ctx.trace.kernel_s(SHEAR_KERNEL)
    if kernel_s <= 0:
        return None
    textures = ctx.traffic["batch"] * PLANES
    ext = PLANE_RES + 2 * MARGIN
    out_bytes = 2 if ctx.gkw["rendering_kwargs"].get("frustum_bf16", True) else 4
    n_bytes = (textures * PLANE_RES * PLANE_RES * CHANNELS * 4
               + textures * ext * CHANNELS * ext * out_bytes)
    bound = counters.bound_s(n_bytes, 0.0, counters.PEAK_FLOPS["bf16"])
    return 100.0 * bound * ctx.trace.units / kernel_s
