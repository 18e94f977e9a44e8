"""StyleGAN3 alias-free synthesis stack, port of `pix2pix3d_tpu/nn/stylegan3.py`
(ref `training/networks_stylegan3.py`), NCHW.

The modulated convolution uses the input-scaling formulation of
`nn/layers.py` with StyleGAN3's pre-normalization and `input_gain` (ref
`:27-67`); the Kaiser / jinc filter design runs in scipy when a layer is
built, as in the JAX package.  Layers whose sampling rate is among the
`num_fp16_res` highest run in bfloat16 tensors, as in the JAX package;
`force_fp32=True` runs everything in f32.

Spans (`utils/profiling.annotate`, a range only under a profiler): `mapping`
and `synthesis` in `GeneratorS3.forward`, `synthesis_input` around the
Fourier-feature input, `modconv` around each layer's modulated convolution;
each layer's `filtered_lrelu` call opens its own span.

Parameter names follow the JAX tree: the synthesis network's layers are its
submodules `L{idx}_{size}_{ch}`, and `SynthesisInput` holds `weight`,
`affine`, and the buffers `transform`, `freqs` and `phases`.  The JAX tree
(like the reference) holds the input's square `weight` as `[out, in]` and
applies `x @ weight.T`; `bridge` transposes every 2-D `weight`, so the port
holds it as `[in, out]` and applies `x @ weight`, the same product.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import scipy.special
import torch
from torch import nn

from ..ops.conv2d_resample import _conv2d
from ..ops.filtered_lrelu import filtered_lrelu
from ..utils.profiling import annotate
from .layers import FullyConnected, randn
from .mapping import MappingNetwork


def modulated_conv2d_s3(x, weight, styles, demodulate=True, padding=0,
                        input_gain=None):
    """StyleGAN3 modconv (ref `networks_stylegan3.py:27-67`): x `[N, I, H, W]`,
    weight `[O, I, kh, kw]`, styles `[N, I]`, input_gain `[N]` or None."""
    w32 = weight.float()
    s32 = styles.float()
    dcoefs = None
    if demodulate:
        # pre-normalize (ref :43-45)
        w32 = w32 * torch.rsqrt(w32.square().mean(dim=(1, 2, 3), keepdim=True))
        s32 = s32 * torch.rsqrt(s32.square().mean())
        w_sq = w32.square().sum(dim=(2, 3))                       # [O, I]
        dcoefs = torch.rsqrt(s32.square() @ w_sq.t() + 1e-8)      # [N, O]
    scale = s32
    if input_gain is not None:
        scale = scale * input_gain.float().reshape(-1, 1)
    x = x * scale.to(x.dtype)[:, :, None, None]
    x = _conv2d(x, w32, padding=(padding,) * 4)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    return x


def design_lowpass_filter(numtaps, cutoff, width, fs, radial=False):
    """Kaiser / radial jinc low-pass design (ref `:380-400`): f32 numpy
    `[numtaps]` or `[numtaps, numtaps]`, or None for one tap."""
    assert numtaps >= 1
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return np.asarray(f, dtype=np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[np.isnan(f)] = cutoff * 2 * cutoff  # limit at r=0
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    wnd = np.kaiser(numtaps, beta)
    f *= np.outer(wnd, wnd)
    f /= np.sum(f)
    return np.asarray(f, dtype=np.float32)


def _filter_buffer(module, name, f):
    """Register filter `f` (numpy or None) as a non-persistent buffer: it
    follows the module's device and is not a parameter of the tree."""
    module.register_buffer(name, None if f is None else torch.from_numpy(f),
                           persistent=False)


class _InputAffine(FullyConnected):
    """The input's affine, drawn as the reference draws it: weight 0, bias
    [1, 0, 0, 0] (the identity rotation, no translation)."""

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.zero_()
            self.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))


class SynthesisInput(nn.Module):
    """Transformed Fourier-feature input (ref `:171-250`)."""

    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth):
        super().__init__()
        self.channels = channels
        self.size = np.broadcast_to(np.asarray(size), [2])
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth
        self.affine = _InputAffine(w_dim, 4)
        self.weight = nn.Parameter(torch.empty(channels, channels))
        self.register_buffer("transform", torch.eye(3))
        self.register_buffer("freqs", torch.empty(channels, 2))
        self.register_buffer("phases", torch.empty(channels))

    def reset_parameters(self, generator):
        with torch.no_grad():
            freqs = randn((self.channels, 2), generator)
            radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
            freqs = freqs / (radii * radii.square().exp() ** 0.25)
            self.freqs.copy_(freqs * self.bandwidth)
            self.phases.copy_(torch.rand(self.channels, generator=generator) - 0.5)
            self.weight.copy_(randn(self.weight.shape, generator))
            self.transform.copy_(torch.eye(3))

    def forward(self, w):
        """w `[N, w_dim]` -> `[N, C, H, W]` f32."""
        n = w.shape[0]
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zeros = torch.zeros(n, device=w.device)
        ones = torch.ones(n, device=w.device)
        m_r = torch.stack([
            torch.stack([t[:, 0], -t[:, 1], zeros], -1),
            torch.stack([t[:, 1], t[:, 0], zeros], -1),
            torch.stack([zeros, zeros, ones], -1)], -2)
        m_t = torch.stack([
            torch.stack([ones, zeros, -t[:, 2]], -1),
            torch.stack([zeros, ones, -t[:, 3]], -1),
            torch.stack([zeros, zeros, ones], -1)], -2)
        transforms = m_r @ m_t @ self.transform[None]

        freqs = self.freqs[None]                                    # [1, C, 2]
        phases = self.phases[None] + (freqs @ transforms[:, :2, 2:])[..., 0]
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)

        # sampling grid (affine_grid, align_corners=False)
        wpix, hpix = int(self.size[0]), int(self.size[1])
        sx = 0.5 * wpix / self.sampling_rate
        sy = 0.5 * hpix / self.sampling_rate
        gx = (torch.arange(wpix, device=w.device) + 0.5) / wpix * 2 - 1
        gy = (torch.arange(hpix, device=w.device) + 0.5) / hpix * 2 - 1
        gyy, gxx = torch.meshgrid(gy * sy, gx * sx, indexing="ij")
        grid = torch.stack([gxx, gyy], -1)                          # [H, W, 2]

        x = torch.einsum("hwk,nck->nchw", grid, freqs)
        x = x + phases[:, :, None, None]
        x = torch.sin(x * (2 * math.pi))
        x = x * amplitudes[:, :, None, None]
        weight = self.weight / math.sqrt(self.channels)          # [in, out]
        return torch.einsum("nchw,cd->ndhw", x, weight)


class SynthesisLayerS3(nn.Module):
    """Alias-free layer: modconv + filtered leaky ReLU resampling (ref
    `:255-378`)."""

    def __init__(self, w_dim, is_torgb, is_critically_sampled, use_fp16,
                 in_channels, out_channels, in_size, out_size,
                 in_sampling_rate, out_sampling_rate, in_cutoff, out_cutoff,
                 in_half_width, out_half_width, conv_kernel=3, filter_size=6,
                 lrelu_upsampling=2, use_radial_filters=False, conv_clamp=256,
                 magnitude_ema_beta=0.999):
        super().__init__()
        self.is_torgb = is_torgb
        self.use_fp16 = use_fp16
        self.in_channels = in_channels
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta
        in_size = np.broadcast_to(np.asarray(in_size), [2])
        out_size = np.broadcast_to(np.asarray(out_size), [2])
        tmp = max(in_sampling_rate, out_sampling_rate) * (
            1 if is_torgb else lrelu_upsampling)

        self.up_factor = int(np.rint(tmp / in_sampling_rate))
        self.up_taps = (filter_size * self.up_factor
                        if self.up_factor > 1 and not is_torgb else 1)
        _filter_buffer(self, "up_filter", design_lowpass_filter(
            self.up_taps, in_cutoff, in_half_width * 2, tmp))

        self.down_factor = int(np.rint(tmp / out_sampling_rate))
        self.down_taps = (filter_size * self.down_factor
                          if self.down_factor > 1 and not is_torgb else 1)
        _filter_buffer(self, "down_filter", design_lowpass_filter(
            self.down_taps, out_cutoff, out_half_width * 2, tmp,
            radial=use_radial_filters and not is_critically_sampled))

        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total = pad_total - (in_size + self.conv_kernel - 1) * self.up_factor
        pad_total = pad_total + self.up_taps + self.down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]),
                        int(pad_lo[1]), int(pad_hi[1])]

        self.affine = FullyConnected(w_dim, in_channels, bias_init=1)
        k = self.conv_kernel
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(randn(self.weight.shape, generator))
            self.bias.zero_()
            self.magnitude_ema.fill_(1.0)

    def forward(self, x, w, force_fp32=False):
        input_gain = torch.rsqrt(self.magnitude_ema)
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles / math.sqrt(self.in_channels * self.conv_kernel ** 2)
        dtype = (torch.bfloat16 if (self.use_fp16 and not force_fp32)
                 else torch.float32)
        with annotate("modconv"):
            x = modulated_conv2d_s3(
                x.to(dtype), self.weight, styles, demodulate=not self.is_torgb,
                padding=self.conv_kernel - 1,
                input_gain=input_gain.expand(x.shape[0]))
        return filtered_lrelu(
            x, fu=self.up_filter, fd=self.down_filter, b=self.bias.to(x.dtype),
            up=self.up_factor, down=self.down_factor, padding=self.padding,
            gain=1 if self.is_torgb else math.sqrt(2),
            slope=1 if self.is_torgb else 0.2, clamp=self.conv_clamp)

    def updated_magnitude_ema(self, x):
        """The EMA of the input's mean square that training would store
        (ref `:321-324`), from this layer's input `x`; the buffer is not
        changed."""
        cur = x.detach().float().square().mean()
        return cur + self.magnitude_ema_beta * (self.magnitude_ema - cur)


class SynthesisNetworkS3(nn.Module):
    """Alias-free synthesis network (ref `:405-489`)."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, num_layers=14, num_critical=2, first_cutoff=2,
                 first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3,
                 margin_size=10, output_scale=0.25, num_fp16_res=4,
                 **layer_kwargs):
        super().__init__()
        self.w_dim = w_dim
        self.num_ws = num_layers + 2
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.output_scale = output_scale

        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(
            np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(
            np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + margin_size * 2
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
        channels[-1] = img_channels

        self.input = SynthesisInput(
            w_dim=w_dim, channels=int(channels[0]), size=int(sizes[0]),
            sampling_rate=sampling_rates[0], bandwidth=cutoffs[0])
        self.layer_names = []  # the reference's L{idx}_{size}_{ch}
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            self.layer_names.append(
                f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}")
            self.add_module(self.layer_names[-1], SynthesisLayerS3(
                    w_dim=w_dim, is_torgb=idx == num_layers,
                    is_critically_sampled=idx >= num_layers - num_critical,
                    use_fp16=sampling_rates[idx] * (2 ** num_fp16_res) > img_resolution,
                    in_channels=int(channels[prev]), out_channels=int(channels[idx]),
                    in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                    in_sampling_rate=int(sampling_rates[prev]),
                    out_sampling_rate=int(sampling_rates[idx]),
                    in_cutoff=cutoffs[prev], out_cutoff=cutoffs[idx],
                    in_half_width=half_widths[prev],
                    out_half_width=half_widths[idx], **layer_kwargs))

    def forward(self, ws, force_fp32=False, **unused_kwargs):
        """ws `[N, num_ws, w_dim]` -> `[N, img_channels, H, W]` f32."""
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"ws {tuple(ws.shape)} has not {self.num_ws} ws")
        ws = ws.float()
        with annotate("synthesis_input"):
            x = self.input(ws[:, 0])
        for i, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, i + 1], force_fp32=force_fp32)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class GeneratorS3(nn.Module):
    """Alias-free generator (ref `:492-517`)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_kwargs=None, **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.synthesis = SynthesisNetworkS3(w_dim=w_dim,
                                            img_resolution=img_resolution,
                                            img_channels=img_channels,
                                            **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.num_ws,
                                      **(mapping_kwargs or {}))

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None,
                **synthesis_kwargs):
        with annotate("mapping"):
            ws = self.mapping(z, c, truncation_psi=truncation_psi,
                              truncation_cutoff=truncation_cutoff)
        with annotate("synthesis"):
            return self.synthesis(ws, **synthesis_kwargs)
