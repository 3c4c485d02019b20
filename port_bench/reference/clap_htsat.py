"""The plain reference of the LAION-CLAP audio tower (HTSAT), in PyTorch.

Written from the published model (LAION-CLAP's HTSAT and Hugging Face's
``ClapAudioModel``), not from the port: it imports nothing of
``audio_metrics_tpu_torch`` and shares no table with it.  Each clip of at
most 10 s at 48 kHz is repeat-padded to 10 s ("repeatpad": whole copies,
then zeros), turned into a log-mel (Hann frames of 1024 samples, hop 480,
reflect-padded at both ends, the power spectrum through a Slaney mel
filterbank of ``n_mels`` bins over ``fmin``-``fmax`` Hz, then
10 log10(max(mel, 1e-10))), normalised per mel bin by the BatchNorm's
running statistics, stretched in time to ``spec_size * freq_ratio``
frames by bicubic interpolation (align_corners), folded into a
(spec_size, spec_size) image, cut into patches by a strided convolution
with a LayerNorm, and run through the Swin stages (shifted windows with a
relative-position bias; patch merging between stages).  The final
LayerNorm's tokens are averaged, projected (linear, ReLU, linear) and
normalised to unit length: the ``embedding`` tap.

Everything runs in f32 in the precision that the caller's matmul settings
give: the benchmark runs it with TF32 off (the reference) and with TF32 on
(the control).  ``embed`` works in batches, so that a large set fits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MAX_SECONDS = 10


def slaney_mel_filterbank(n_freqs: int, n_mels: int, fmin: float, fmax: float,
                          sr: int) -> np.ndarray:
    """(n_freqs, n_mels) triangular filters on the Slaney mel scale, slopes
    in hertz, each filter scaled to unit area (librosa's ``norm="slaney"``),
    in float64."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        lin = m * (200.0 / 3)
        log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
        return np.where(m >= 15.0, log, lin)

    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return fb


def relative_position_index(window: int) -> torch.Tensor:
    """(window^2, window^2) index into the (2w-1)^2-row bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(resolution: int, window: int, shift: int) -> torch.Tensor:
    """(n_windows, w^2, w^2) additive mask of shifted-window attention:
    -100 between tokens that came from different regions of the rolled
    image, 0 elsewhere."""
    img = torch.zeros(resolution, resolution)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    label = 0
    for rows in cuts:
        for cols in cuts:
            img[rows, cols] = label
            label += 1
    wins = partition(img[None, :, :, None], window).squeeze(-1)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, w^2, C), windows in row order."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def unpartition(x: torch.Tensor, window: int, b: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.view(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class ClapHTSAT:
    """The reference forward of one configuration with one set of weights
    (a dict of arrays or tensors under the Hugging Face CLAP names), held
    on ``device`` in f32."""

    def __init__(self, cfg: dict, params: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.p = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(self.device)
                  for k, v in params.items()}
        fb = slaney_mel_filterbank(cfg["n_fft"] // 2 + 1, cfg["n_mels"], cfg["fmin"],
                                   cfg["fmax"], cfg["sample_rate"])
        self.fb = torch.from_numpy(fb.astype(np.float32)).to(self.device)
        self.window = torch.hann_window(cfg["n_fft"], periodic=True, device=self.device)
        self._tables = {}

    def _table(self, window: int, resolution: int, shift: int):
        key = (window, resolution, shift)
        if key not in self._tables:
            mask = shift_mask(resolution, window, shift).to(self.device) if shift else None
            self._tables[key] = (relative_position_index(window).to(self.device), mask)
        return self._tables[key]

    # -- frontend ----------------------------------------------------------
    def log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n) clips of at most 10 s -> (B, frames, n_mels) dB log-mel of
        the repeat-padded 10 s clip."""
        cfg = self.cfg
        total = MAX_SECONDS * cfg["sample_rate"]
        n = audio.shape[1]
        if n < total:
            audio = F.pad(audio.repeat(1, total // n), (0, total - (total // n) * n))
        spec = torch.stft(audio, cfg["n_fft"], hop_length=cfg["hop"], window=self.window,
                          center=True, pad_mode="reflect", return_complex=True)
        power = spec.real.square() + spec.imag.square()  # (B, freqs, frames)
        mel = torch.matmul(power.transpose(1, 2), self.fb)
        return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))

    def tokens(self, mel: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.p
        pre = "audio_encoder."
        x = (mel - p[pre + "batch_norm.running_mean"]) / torch.sqrt(
            p[pre + "batch_norm.running_var"] + 1e-5)
        x = x * p[pre + "batch_norm.weight"] + p[pre + "batch_norm.bias"]
        ratio = cfg["spec_size"] // cfg["n_mels"]
        width = cfg["spec_size"] * ratio
        b, t, f = x.shape
        x = x[:, None]
        if t < width:
            x = F.interpolate(x, size=(width, f), mode="bicubic", align_corners=True)
        # (B, 1, time, freq) -> (B, 1, ratio * freq, time / ratio): the time
        # axis cut into ``ratio`` chunks stacked along frequency
        x = x.reshape(b, ratio, width // ratio, f).permute(0, 1, 3, 2)
        x = x.reshape(b, 1, ratio * f, width // ratio)
        x = F.conv2d(x, p[pre + "patch_embed.proj.weight"], p[pre + "patch_embed.proj.bias"],
                     stride=cfg["patch_stride"])
        x = x.flatten(2).transpose(1, 2)
        return self.ln(x, pre + "patch_embed.norm")

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"],
                            self.cfg["layer_norm_eps"])

    def linear(self, x, name, bias=True):
        return F.linear(x, self.p[name + ".weight"], self.p[name + ".bias"] if bias else None)

    # -- Swin --------------------------------------------------------------
    def block(self, x, name, resolution, heads, shift):
        window = self.cfg["window_size"]
        if resolution <= window:
            window, shift = resolution, 0
        b, n, c = x.shape
        d = c // heads
        h = self.ln(x, name + ".layernorm_before").view(b, resolution, resolution, c)
        if shift:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
        w = partition(h, window)  # (B * nW, w^2, C)
        att = name + ".attention."
        q, k, v = (self.linear(w, att + "self." + s).view(w.shape[0], -1, heads, d)
                   .transpose(1, 2) for s in ("query", "key", "value"))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        index, mask = self._table(window, resolution, shift)
        table = self.p[att + "self.relative_position_bias_table"]
        scores = scores + table[index.reshape(-1)].view(window**2, window**2, heads) \
            .permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.view(b, nw, heads, window**2, window**2) + mask[None, :, None]) \
                .view(-1, heads, window**2, window**2)
        out = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(w.shape)
        out = self.linear(out, att + "output.dense")
        out = unpartition(out, window, b, resolution, resolution)
        if shift:
            out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
        x = x + out.reshape(b, n, c)
        h = self.ln(x, name + ".layernorm_after")
        h = F.gelu(self.linear(h, name + ".intermediate.dense"))
        return x + self.linear(h, name + ".output.dense")

    def merge(self, x, name, resolution):
        b, _, c = x.shape
        x = x.view(b, resolution, resolution, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).view(b, -1, 4 * c)
        return self.linear(self.ln(x, name + ".norm"), name + ".reduction", bias=False)

    @torch.no_grad()
    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n) f32 clips -> (B, projection) unit-length embeddings."""
        cfg = self.cfg
        x = self.tokens(self.log_mel(audio.to(self.device, torch.float32)))
        resolution = cfg["spec_size"] // cfg["patch_stride"]
        for i, depth in enumerate(cfg["depths"]):
            for j in range(depth):
                shift = cfg["window_size"] // 2 if j % 2 else 0
                x = self.block(x, f"audio_encoder.layers.{i}.blocks.{j}", resolution,
                               cfg["num_heads"][i], shift)
            if i < len(cfg["depths"]) - 1:
                x = self.merge(x, f"audio_encoder.layers.{i}.downsample", resolution)
                resolution //= 2
        latent = self.ln(x, "audio_encoder.norm").mean(dim=1)
        h = torch.relu(self.linear(latent, "audio_projection.linear1"))
        e = self.linear(h, "audio_projection.linear2")
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    def embed(self, audio: torch.Tensor, batch: int = 64) -> torch.Tensor:
        """(N, n) clips -> (N, projection) f32 embeddings on this device, in
        batches of ``batch`` rows."""
        return torch.cat([self.forward(audio[i : i + batch])
                          for i in range(0, audio.shape[0], batch)])
