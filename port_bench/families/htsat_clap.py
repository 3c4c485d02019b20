"""The LAION-CLAP audio tower (HTSAT): its weights from a seed, the port's
embedder built on them, and the plain reference built on the same.

The weights are a dict of f32 numpy arrays under the Hugging Face CLAP
names, which is what the port's ``LaionCLAP(params=...)`` takes.  They are
drawn on the device from the seed in one normal and one uniform call,
scaled per tensor, and copied to the host once.
"""

from __future__ import annotations

import numpy as np
import torch


def param_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight the audio tower and its
    projection read; kind says how the seed fills it: ``matrix`` (std
    1/sqrt(fan_in)), ``vector`` (biases, std 0.02), ``table``
    (relative-position tables, std 0.5), ``scale`` (1 + N(0, 0.1^2)),
    ``mean`` (N(0, 1)), ``var`` (U(0.5, 3))."""
    e, mels, ps, w = cfg["embed_dim"], cfg["n_mels"], cfg["patch_size"], cfg["window_size"]
    out = [(f"audio_encoder.batch_norm.{k}", (mels,), kind) for k, kind in
           (("weight", "scale"), ("bias", "vector"), ("running_mean", "mean"),
            ("running_var", "var"))]
    out += [("audio_encoder.patch_embed.proj.weight", (e, 1, ps, ps), "matrix"),
            ("audio_encoder.patch_embed.proj.bias", (e,), "vector")]

    def ln(name, c):
        out.extend([(f"{name}.weight", (c,), "scale"), (f"{name}.bias", (c,), "vector")])

    def lin(name, c_in, c_out, bias=True):
        out.append((f"{name}.weight", (c_out, c_in), "matrix"))
        if bias:
            out.append((f"{name}.bias", (c_out,), "vector"))

    ln("audio_encoder.patch_embed.norm", e)
    for i, depth in enumerate(cfg["depths"]):
        c = e * 2**i
        for j in range(depth):
            pre = f"audio_encoder.layers.{i}.blocks.{j}"
            ln(f"{pre}.layernorm_before", c)
            for name in ("query", "key", "value"):
                lin(f"{pre}.attention.self.{name}", c, c)
            out.append((f"{pre}.attention.self.relative_position_bias_table",
                        ((2 * w - 1) ** 2, cfg["num_heads"][i]), "table"))
            lin(f"{pre}.attention.output.dense", c, c)
            ln(f"{pre}.layernorm_after", c)
            hidden = int(cfg["mlp_ratio"] * c)
            lin(f"{pre}.intermediate.dense", c, hidden)
            lin(f"{pre}.output.dense", hidden, c)
        if i < len(cfg["depths"]) - 1:
            ln(f"audio_encoder.layers.{i}.downsample.norm", 4 * c)
            lin(f"audio_encoder.layers.{i}.downsample.reduction", 4 * c, 2 * c, bias=False)
    feat = e * 2 ** (len(cfg["depths"]) - 1)
    ln("audio_encoder.norm", feat)
    lin("audio_projection.linear1", feat, cfg["projection_dim"])
    lin("audio_projection.linear2", cfg["projection_dim"], cfg["projection_dim"])
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """The weights of ``cfg`` drawn from ``seed`` on ``device``: a dict of
    f32 numpy arrays (the same seed gives the same weights on one kind of
    device)."""
    shapes = param_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    scale = torch.empty_like(z)
    shift = torch.zeros_like(z)
    pos = 0
    for (_, shape, kind), n in zip(shapes, sizes):
        part = slice(pos, pos + n)
        if kind == "matrix":
            scale[part] = float(np.prod(shape[1:])) ** -0.5
        elif kind == "vector":
            scale[part] = 0.02
        elif kind == "table":
            scale[part] = 0.5
        elif kind == "scale":
            scale[part], shift[part] = 0.1, 1.0
        elif kind == "mean":
            scale[part] = 1.0
        else:  # var: U(0.5, 3)
            z[part], scale[part], shift[part] = u[part], 2.5, 0.5
        pos += n
    flat = (z * scale + shift).cpu().numpy()
    out, pos = {}, 0
    for (name, shape, _), n in zip(shapes, sizes):
        out[name] = flat[pos : pos + n].reshape(shape)
        pos += n
    return out


def port_config(cfg: dict):
    """The port's ``HTSATConfig`` of ``cfg``."""
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig

    return HTSATConfig(spec_size=cfg["spec_size"], patch_size=cfg["patch_size"],
                       patch_stride=cfg["patch_stride"], num_mel_bins=cfg["n_mels"],
                       embed_dim=cfg["embed_dim"], depths=tuple(cfg["depths"]),
                       num_heads=tuple(cfg["num_heads"]), window_size=cfg["window_size"],
                       mlp_ratio=cfg["mlp_ratio"], layer_norm_eps=cfg["layer_norm_eps"])


def build_port(cfg: dict, params: dict, device):
    """The port's embedder of ``cfg`` on ``params``, in the configuration's
    dtype, on its default paths."""
    from audio_metrics_tpu_torch.models.clap import LaionCLAP

    return LaionCLAP(params=params, cfg=port_config(cfg), layer=cfg["tap"],
                     compute_dtype=None if cfg["dtype"] == "float32" else cfg["dtype"],
                     device=device)


def build_reference(cfg: dict, params: dict, device):
    """The plain reference forward of ``cfg`` on ``params``."""
    from ..reference.clap_htsat import ClapHTSAT

    return ClapHTSAT(cfg, params, device)
