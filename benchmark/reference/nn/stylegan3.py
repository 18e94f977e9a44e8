"""StyleGAN3 (alias-free generator), plain: the benchmark's reference, f32.

Follows the published `training/networks_stylegan3.py` of NVlabs/stylegan3:
the mapping network (2 layers for the T and R configurations), the
Fourier-feature input under a per-sample affine transform, and
`num_layers + 1` layers, each a modulated convolution followed by the
filtered leaky ReLU (`ops/filtered_lrelu.py`, the published
`_filtered_lrelu_ref`).  Filters are designed as published (Kaiser-windowed
`scipy.signal.firwin`, or the radial jinc filter of the R configuration);
scipy designs them and computes nothing else.

Plain means: every tensor f32 (the caller keeps TF32 off), the published
per-sample modulated weights in one grouped convolution, the FIR filters as
zero-insertion and grouped convolutions, no kernel of the program.

Departures of layout, not of math, so that one set of weights loads into
this model and into the program's (`weights.draw` gives both the same
values by name):
- the input's square `weight` is held `[in, out]` and applied `x @ weight`
  (published: `[out, in]`, `x @ weight.t()`);
- the mapping network is the frozen StyleGAN2 one (`nn/mapping.py`), whose
  `fc0`, `fc1` and `w_avg` at `num_layers` 2 and `c_dim` 0 are the
  published StyleGAN3 mapping's;
- the filters are buffers that a `state_dict` leaves out, as the program's.
Layers whose sampling rate is among the `num_fp16_res` highest carry
`use_fp16`, which this reference does not act on: it marks the layers that
the program runs in bf16, for the control's precision.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filtered_lrelu import FilteredLrelu
from .layers import FullyConnected
from .mapping import MappingNetwork


def modulated_conv2d(x, w, s, demodulate=True, padding=0, input_gain=None):
    """The published modulated convolution: x `[N, I, H, W]`, w
    `[O, I, kh, kw]`, s `[N, I]`, input_gain `[N]` or None; per-sample
    weights, pre-normalized and demodulated, in one grouped convolution."""
    n = x.shape[0]
    out_channels, in_channels, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)   # [N, O, I, kh, kw]
    if demodulate:
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()      # [N, O]
        w = w * dcoefs.unsqueeze(2).unsqueeze(3).unsqueeze(4)
    if input_gain is not None:
        gain = input_gain.expand(n, in_channels)
        w = w * gain.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    x = x.reshape(1, -1, *x.shape[2:])
    w = w.reshape(-1, in_channels, kh, kw)
    x = F.conv2d(x, w.to(x.dtype), padding=padding, groups=n)
    return x.reshape(n, -1, *x.shape[2:])


def design_lowpass_filter(numtaps, cutoff, width, fs, radial=False):
    """The published filter design: None for one tap, a separable
    Kaiser-windowed low-pass `[numtaps]`, or a radial jinc `[numtaps,
    numtaps]` (f32 tensors on the default device)."""
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return torch.tensor(np.asarray(f, dtype=np.float32))
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    wnd = np.kaiser(numtaps, beta)
    f *= np.outer(wnd, wnd)
    f /= np.sum(f)
    return torch.tensor(np.asarray(f, dtype=np.float32))


class SynthesisInput(nn.Module):
    """Fourier features at `size`^2 under the affine transform that `w`
    gives each sample (rotation, then translation), then a trainable
    channel mix."""

    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth):
        super().__init__()
        self.channels = channels
        self.size = np.broadcast_to(np.asarray(size), [2])
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth
        self.affine = FullyConnected(w_dim, 4)
        self.weight = nn.Parameter(torch.empty(channels, channels))    # [in, out]
        self.register_buffer("transform", torch.eye(3))
        self.register_buffer("freqs", torch.empty(channels, 2))
        self.register_buffer("phases", torch.empty(channels))

    def forward(self, w):
        n = w.shape[0]
        transforms = self.transform.unsqueeze(0)
        freqs = self.freqs.unsqueeze(0)
        phases = self.phases.unsqueeze(0)

        t = self.affine(w)                                    # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([n, 1, 1])
        m_r[:, 0, 0] = t[:, 0]
        m_r[:, 0, 1] = -t[:, 1]
        m_r[:, 1, 0] = t[:, 1]
        m_r[:, 1, 1] = t[:, 0]
        m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([n, 1, 1])
        m_t[:, 0, 2] = -t[:, 2]
        m_t[:, 1, 2] = -t[:, 3]
        transforms = m_r @ m_t @ transforms

        phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)

        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = 0.5 * self.size[0] / self.sampling_rate
        theta[1, 1] = 0.5 * self.size[1] / self.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0), [1, 1, int(self.size[1]), int(self.size[0])],
                              align_corners=False)

        x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
        x = x + phases.unsqueeze(1).unsqueeze(2)
        x = torch.sin(x * (np.pi * 2))
        x = x * amplitudes.unsqueeze(1).unsqueeze(2)
        x = x @ (self.weight / np.sqrt(self.channels))        # [N, H, W, C]
        return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    """Modulated convolution, then bias, upsampling FIR, leaky ReLU with
    its gain and clamp, and downsampling FIR."""

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
        self.out_channels = out_channels
        self.in_size = np.broadcast_to(np.asarray(in_size), [2])
        self.out_size = np.broadcast_to(np.asarray(out_size), [2])
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.tmp_sampling_rate = max(in_sampling_rate, out_sampling_rate) * (
            1 if is_torgb else lrelu_upsampling)

        self.up_factor = int(np.rint(self.tmp_sampling_rate / in_sampling_rate))
        self.up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        self._filter("up_filter", design_lowpass_filter(
            self.up_taps, in_cutoff, in_half_width * 2, self.tmp_sampling_rate))

        self.down_factor = int(np.rint(self.tmp_sampling_rate / out_sampling_rate))
        self.down_taps = (filter_size * self.down_factor
                          if self.down_factor > 1 and not is_torgb else 1)
        self.down_radial = use_radial_filters and not is_critically_sampled
        self._filter("down_filter", design_lowpass_filter(
            self.down_taps, out_cutoff, out_half_width * 2, self.tmp_sampling_rate,
            radial=self.down_radial))

        pad_total = (self.out_size - 1) * self.down_factor + 1
        pad_total = pad_total - (self.in_size + self.conv_kernel - 1) * self.up_factor
        pad_total = pad_total + self.up_taps + self.down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1])]

        self.affine = FullyConnected(w_dim, in_channels, bias_init=1)
        k = self.conv_kernel
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))
        self.filtered_lrelu = FilteredLrelu()

    def _filter(self, name, f):
        self.register_buffer(name, f, persistent=False)

    def forward(self, x, w):
        input_gain = self.magnitude_ema.rsqrt()
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / np.sqrt(self.in_channels * self.conv_kernel ** 2))
        x = modulated_conv2d(x, self.weight, styles, demodulate=not self.is_torgb,
                             padding=self.conv_kernel - 1, input_gain=input_gain)
        return self.filtered_lrelu(
            x, fu=self.up_filter, fd=self.down_filter, b=self.bias, up=self.up_factor,
            down=self.down_factor, padding=self.padding,
            gain=1 if self.is_torgb else math.sqrt(2), slope=1 if self.is_torgb else 0.2,
            clamp=self.conv_clamp)


class SynthesisNetwork(nn.Module):
    """The input and `num_layers + 1` layers at the published geometric
    progression of cutoffs, stopbands, sampling rates and sizes."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, num_layers=14, num_critical=2, first_cutoff=2,
                 first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, margin_size=10,
                 output_scale=0.25, num_fp16_res=4, **layer_kwargs):
        super().__init__()
        self.w_dim = w_dim
        self.num_ws = num_layers + 2
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.output_scale = output_scale

        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + margin_size * 2
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
        channels[-1] = img_channels

        self.input = SynthesisInput(w_dim=w_dim, channels=int(channels[0]),
                                    size=int(sizes[0]), sampling_rate=sampling_rates[0],
                                    bandwidth=cutoffs[0])
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            layer = SynthesisLayer(
                w_dim=w_dim, is_torgb=idx == num_layers,
                is_critically_sampled=idx >= num_layers - num_critical,
                use_fp16=bool(sampling_rates[idx] * (2 ** num_fp16_res) > img_resolution),
                in_channels=int(channels[prev]), out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=int(sampling_rates[prev]),
                out_sampling_rate=int(sampling_rates[idx]),
                in_cutoff=cutoffs[prev], out_cutoff=cutoffs[idx],
                in_half_width=half_widths[prev], out_half_width=half_widths[idx],
                **layer_kwargs)
            name = f"L{idx}_{layer.out_size[0]}_{layer.out_channels}"
            setattr(self, name, layer)
            self.layer_names.append(name)

    def forward(self, ws):
        ws = ws.to(torch.float32).unbind(dim=1)
        x = self.input(ws[0])
        for name, w in zip(self.layer_names, ws[1:]):
            x = getattr(self, name)(x, w)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.to(torch.float32)


class GeneratorS3(nn.Module):
    """Mapping, then synthesis: z `[N, z_dim]`, c `[N, c_dim]` -> images
    `[N, img_channels, img_resolution, img_resolution]`."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_kwargs=None, **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.synthesis = SynthesisNetwork(w_dim=w_dim, img_resolution=img_resolution,
                                          img_channels=img_channels, **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.num_ws, **(mapping_kwargs or {}))

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws)
