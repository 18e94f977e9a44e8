"""Legacy TensorFlow StyleGAN2(-ADA) pickle converter, port of
`pix2pix3d_tpu/utils/legacy_tf.py` (ref `legacy.py:24-60` detection,
`:75-130` generator kwargs, `:169-205` generator params, `:213-291`
discriminator).

A legacy pickle is a 3-tuple (G, D, Gs) of `dnnlib.tflib.network.Network`
objects whose state carries `static_kwargs`, `variables` [(name,
np.ndarray)...] and nested `components`.  They are unpickled with a
restricted loader (numpy arrays only; the embedded TF build source is never
executed), the TF variable names and layouts are translated into a
reference-style state_dict, and `utils/convert.convert_state_dict` turns it
into the JAX package's param tree (numpy), the template being
`bridge.params_to_jax` of the port's `nn.synthesis.Generator` /
`nn.discriminator.Discriminator` built from the converted kwargs.  So each
network comes out as `(kwargs, tree)`, as the JAX package returns it:
`bridge.params_from_jax(tree)` loads it into `Generator(**kwargs)`.

Scope matches the reference tool: StyleGAN2 / StyleGAN2-ADA TF pickles,
version >= 4 (`legacy.py:110,215`); StyleGAN1 and configs A-D are refused.

    python -m pix2pix3d_tpu_torch.utils.legacy_tf --source old.pkl --dest new.ckpt

writes a checkpoint in the JAX package's format (`train/checkpoint.py`)
with every network's kwargs in the `.json` sidecar, as
scripts/convert_legacy_tf.py does.
"""

from __future__ import annotations

import argparse
import pickle
import re

import numpy as np

from .. import bridge
from ..nn.discriminator import Discriminator
from ..nn.synthesis import Generator
from ..train.checkpoint import save_checkpoint
from .convert import convert_state_dict

_ALLOWED_GLOBALS = {
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
}


class TFNetworkStub:
    """Holds a legacy `dnnlib.tflib.network.Network` pickle state without
    executing any of its embedded build source."""

    def __setstate__(self, state):
        self.state = dict(state)

    @property
    def version(self):
        return self.state.get("version", 0)

    @property
    def static_kwargs(self):
        return dict(self.state.get("static_kwargs", {}))

    @property
    def variables(self):
        return list(self.state.get("variables", []))

    @property
    def components(self):
        comps = self.state.get("components", {})
        if isinstance(comps, TFNetworkStub):  # old pickles wrap in EasyDict
            comps = comps.state
        return dict(comps)


class _EasyDictStub(dict):
    """dnnlib.EasyDict stand-in: plain dict with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class _RestrictedTFUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "dnnlib.tflib.network" and name == "Network":
            return TFNetworkStub
        if module == "dnnlib" and name == "EasyDict":
            return _EasyDictStub
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"legacy-TF loader: refusing to unpickle {module}.{name}")


def is_tf_pickle(data):
    return (isinstance(data, tuple) and len(data) == 3
            and all(isinstance(n, TFNetworkStub) for n in data))


def load_tf_pickle(path_or_file):
    """Unpickle a legacy TF pickle -> (G, D, Gs) TFNetworkStub tuple."""
    if hasattr(path_or_file, "read"):
        data = _RestrictedTFUnpickler(path_or_file).load()
    else:
        with open(path_or_file, "rb") as f:
            data = _RestrictedTFUnpickler(f).load()
    if not is_tf_pickle(data):
        raise ValueError("not a legacy TF network pickle "
                         "(expected a (G, D, Gs) tuple)")
    return data


def _collect_tf_params(stub):
    """Flatten variables of a network and its components
    (ref `legacy.py:76-86`)."""
    out = {}

    def recurse(prefix, net):
        for name, value in net.variables:
            out[prefix + name] = np.asarray(value)
        for name, comp in net.components.items():
            recurse(prefix + name + "/", comp)

    recurse("", stub)
    return out


def _kwarg_reader(tf_kwargs):
    known = set()

    def kwarg(name, default=None, none=None):
        known.add(name)
        val = tf_kwargs.get(name, default)
        return val if val is not None else none

    return kwarg, known


def _check_unknown(tf_kwargs, known, *ignored):
    for name in ignored:
        known.add(name)
    unknown = sorted(set(tf_kwargs) - known)
    if unknown:
        raise ValueError(f"unknown TensorFlow kwarg {unknown[0]!r}")


def _per_lod(tf_params, layer, img_resolution):
    """Rename the per-lod `{layer}_lod{k}/...` variables of old
    progressive-growing pickles to `{r}x{r}/{layer}/...`; True if any."""
    found = False
    for name, value in list(tf_params.items()):
        m = re.fullmatch(rf"{layer}_lod(\d+)/(.*)", name)
        if m:
            r = img_resolution // (2 ** int(m.group(1)))
            tf_params[f"{r}x{r}/{layer}/{m.group(2)}"] = value
            found = True
    return found


def convert_tf_generator(stub):
    """TF generator stub -> (the `nn.synthesis.Generator` kwargs, param tree
    in the JAX package's layout).

    The reference's kwarg table (`legacy.py:113-145`) and param patterns
    (`legacy.py:169-205`): dense weights transpose, conv weights HWIO->OIHW
    with a spatial flip on up-convolutions, modulation bias +1, per-layer
    noise buffers renumbered from the flat `synthesis/noise{i}` list, and
    `ToRGB_lod*` (progressive growing) selects the 'orig' architecture."""
    if stub.version < 4:
        raise ValueError("TensorFlow pickle version too low")
    kwarg, known = _kwarg_reader(stub.static_kwargs)
    kwargs = dict(
        z_dim=kwarg("latent_size", 512),
        c_dim=kwarg("label_size", 0),
        w_dim=kwarg("dlatent_size", 512),
        img_resolution=kwarg("resolution", 1024),
        img_channels=kwarg("num_channels", 3),
        channel_base=kwarg("fmap_base", 16384) * 2,
        channel_max=kwarg("fmap_max", 512),
        num_fp16_res=kwarg("num_fp16_res", 0),
        conv_clamp=kwarg("conv_clamp", None),
        architecture=kwarg("architecture", "skip"),
        resample_filter=kwarg("resample_kernel", [1, 3, 3, 1]),
        use_noise=kwarg("use_noise", True),
        activation=kwarg("nonlinearity", "lrelu"),
        mapping_kwargs=dict(
            num_layers=kwarg("mapping_layers", 8),
            embed_features=kwarg("label_fmaps", None),
            layer_features=kwarg("mapping_fmaps", None),
            activation=kwarg("mapping_nonlinearity", "lrelu"),
            lr_multiplier=kwarg("mapping_lrmul", 0.01),
            w_avg_beta=kwarg("w_avg_beta", 0.995, none=1),
        ),
    )
    _check_unknown(stub.static_kwargs, known, "truncation_psi",
                   "truncation_cutoff", "style_mixing_prob", "structure",
                   "conditioning", "fused_modconv")

    tf_params = _collect_tf_params(stub)
    if _per_lod(tf_params, "ToRGB", kwargs["img_resolution"]):
        kwargs["architecture"] = "orig"

    def conv(name, flip=False):
        w = tf_params[name]  # TF layout [kh, kw, in, out]
        if flip:
            w = w[::-1, ::-1]
        return w.transpose(3, 2, 0, 1)  # OIHW; convert_state_dict -> HWIO

    sd = {"mapping.w_avg": tf_params["dlatent_avg"]}
    if kwargs["c_dim"] > 0:
        sd["mapping.embed.weight"] = tf_params["mapping/LabelEmbed/weight"].T
        sd["mapping.embed.bias"] = tf_params["mapping/LabelEmbed/bias"]
    for i in range(kwargs["mapping_kwargs"]["num_layers"]):
        sd[f"mapping.fc{i}.weight"] = tf_params[f"mapping/Dense{i}/weight"].T
        sd[f"mapping.fc{i}.bias"] = tf_params[f"mapping/Dense{i}/bias"]

    def layer(torch_prefix, tf_prefix, noise_idx, flip=False):
        sd[f"{torch_prefix}.weight"] = conv(f"{tf_prefix}/weight", flip)
        sd[f"{torch_prefix}.bias"] = tf_params[f"{tf_prefix}/bias"]
        sd[f"{torch_prefix}.affine.weight"] = \
            tf_params[f"{tf_prefix}/mod_weight"].T
        sd[f"{torch_prefix}.affine.bias"] = \
            tf_params[f"{tf_prefix}/mod_bias"] + 1
        if noise_idx is not None and kwargs["use_noise"]:
            sd[f"{torch_prefix}.noise_const"] = \
                tf_params[f"synthesis/noise{noise_idx}"][0, 0]
            sd[f"{torch_prefix}.noise_strength"] = \
                tf_params[f"{tf_prefix}/noise_strength"]

    sd["synthesis.b4.const"] = tf_params["synthesis/4x4/Const/const"][0]
    layer("synthesis.b4.conv1", "synthesis/4x4/Conv", 0)
    layer("synthesis.b4.torgb", "synthesis/4x4/ToRGB", None)
    res = 8
    while res <= kwargs["img_resolution"]:
        lg = int(np.log2(res))
        layer(f"synthesis.b{res}.conv0", f"synthesis/{res}x{res}/Conv0_up",
              2 * lg - 5, flip=True)
        layer(f"synthesis.b{res}.conv1", f"synthesis/{res}x{res}/Conv1",
              2 * lg - 4)
        layer(f"synthesis.b{res}.torgb", f"synthesis/{res}x{res}/ToRGB",
              None)
        if f"synthesis/{res}x{res}/Skip/weight" in tf_params:
            sd[f"synthesis.b{res}.skip.weight"] = conv(
                f"synthesis/{res}x{res}/Skip/weight", flip=True)
        res *= 2

    return kwargs, convert_state_dict(sd, bridge.params_to_jax(Generator(**kwargs)))


def convert_tf_discriminator(stub):
    """TF discriminator stub -> (the `nn.discriminator.Discriminator`
    kwargs, param tree in the JAX package's layout).  Kwarg table: ref
    `legacy.py:219-249`; params: `legacy.py:274-291`; `FromRGB_lod*`
    selects the 'orig' architecture."""
    if stub.version < 4:
        raise ValueError("TensorFlow pickle version too low")
    kwarg, known = _kwarg_reader(stub.static_kwargs)
    kwargs = dict(
        c_dim=kwarg("label_size", 0),
        img_resolution=kwarg("resolution", 1024),
        img_channels=kwarg("num_channels", 3),
        architecture=kwarg("architecture", "resnet"),
        channel_base=kwarg("fmap_base", 16384) * 2,
        channel_max=kwarg("fmap_max", 512),
        num_fp16_res=kwarg("num_fp16_res", 0),
        conv_clamp=kwarg("conv_clamp", None),
        cmap_dim=kwarg("mapping_fmaps", None),
        block_kwargs=dict(
            activation=kwarg("nonlinearity", "lrelu"),
            resample_filter=kwarg("resample_kernel", [1, 3, 3, 1]),
            freeze_layers=kwarg("freeze_layers", 0),
        ),
        mapping_kwargs=dict(
            num_layers=kwarg("mapping_layers", 0),
            embed_features=kwarg("mapping_fmaps", None),
            layer_features=kwarg("mapping_fmaps", None),
            activation=kwarg("nonlinearity", "lrelu"),
            lr_multiplier=kwarg("mapping_lrmul", 0.1),
        ),
        epilogue_kwargs=dict(
            mbstd_group_size=kwarg("mbstd_group_size", None),
            mbstd_num_channels=kwarg("mbstd_num_features", 1),
            activation=kwarg("nonlinearity", "lrelu"),
        ),
    )
    _check_unknown(stub.static_kwargs, known, "structure", "conditioning")

    tf_params = _collect_tf_params(stub)
    if _per_lod(tf_params, "FromRGB", kwargs["img_resolution"]):
        kwargs["architecture"] = "orig"

    def conv(name):
        return tf_params[name].transpose(3, 2, 0, 1)

    sd = {}
    res = kwargs["img_resolution"]
    while res >= 8:
        if f"{res}x{res}/FromRGB/weight" in tf_params:
            sd[f"b{res}.fromrgb.weight"] = conv(f"{res}x{res}/FromRGB/weight")
            sd[f"b{res}.fromrgb.bias"] = tf_params[f"{res}x{res}/FromRGB/bias"]
        sd[f"b{res}.conv0.weight"] = conv(f"{res}x{res}/Conv0/weight")
        sd[f"b{res}.conv0.bias"] = tf_params[f"{res}x{res}/Conv0/bias"]
        sd[f"b{res}.conv1.weight"] = conv(f"{res}x{res}/Conv1_down/weight")
        sd[f"b{res}.conv1.bias"] = tf_params[f"{res}x{res}/Conv1_down/bias"]
        if f"{res}x{res}/Skip/weight" in tf_params:
            sd[f"b{res}.skip.weight"] = conv(f"{res}x{res}/Skip/weight")
        res //= 2
    if kwargs["c_dim"] > 0:
        sd["mapping.embed.weight"] = tf_params["LabelEmbed/weight"].T
        sd["mapping.embed.bias"] = tf_params["LabelEmbed/bias"]
    for i in range(kwargs["mapping_kwargs"]["num_layers"]):
        sd[f"mapping.fc{i}.weight"] = tf_params[f"Mapping{i}/weight"].T
        sd[f"mapping.fc{i}.bias"] = tf_params[f"Mapping{i}/bias"]
    if "4x4/FromRGB/weight" in tf_params:
        sd["b4.fromrgb.weight"] = conv("4x4/FromRGB/weight")
        sd["b4.fromrgb.bias"] = tf_params["4x4/FromRGB/bias"]
    sd["b4.conv.weight"] = conv("4x4/Conv/weight")
    sd["b4.conv.bias"] = tf_params["4x4/Conv/bias"]
    sd["b4.fc.weight"] = tf_params["4x4/Dense0/weight"].T
    sd["b4.fc.bias"] = tf_params["4x4/Dense0/bias"]
    sd["b4.out.weight"] = tf_params["Output/weight"].T
    sd["b4.out.bias"] = tf_params["Output/bias"]

    return kwargs, convert_state_dict(sd, bridge.params_to_jax(Discriminator(**kwargs)))


def load_legacy_tf_networks(path_or_file):
    """Full conversion: legacy TF pickle -> {"G", "D", "G_ema": (kwargs,
    tree)} (ref `load_network_pkl`, `legacy.py:28-37`)."""
    tf_G, tf_D, tf_Gs = load_tf_pickle(path_or_file)
    return {
        "G": convert_tf_generator(tf_G),
        "D": convert_tf_discriminator(tf_D),
        "G_ema": convert_tf_generator(tf_Gs),
    }


def main(argv=None):
    """Convert `--source` (a legacy TF pickle) into the checkpoint `--dest`
    with the networks' kwargs in `--dest`.json."""
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--source", required=True, help="legacy TF pickle")
    p.add_argument("--dest", required=True, help="output checkpoint path")
    args = p.parse_args(argv)

    print(f'Loading "{args.source}"...')
    nets = load_legacy_tf_networks(args.source)
    print(f'Saving "{args.dest}"...')
    save_checkpoint(args.dest, {name: kp[1] for name, kp in nets.items()},
                    config={name: kp[0] for name, kp in nets.items()}, step=0)
    print("Done.")


if __name__ == "__main__":
    main()
