"""The bounds that ``chip_smoke.py`` holds the log-mel kernels and the fused
frontend to count the frequency bins that their filterbank weighs, not the
kernels' DFT basis padded to whole N tiles (384 bins for CLAP, 256 for
VGGish): CLAP's 50-14000 Hz at 48 kHz, n_fft 1024, weighs 299 bins;
VGGish's 125-7500 Hz at 16 kHz, n_fft 512, 240."""

import importlib.util
from pathlib import Path

import pytest

from audio_metrics_tpu_torch.models.clap import _clap_fb
from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, HTSAT_TINY
from audio_metrics_tpu_torch.ops.frontend_fused import FRAME, HOP, _plan

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)


def test_fb_bins_counts_the_bins_each_filterbank_weighs():
    assert smoke.fb_bins(_clap_fb()) == 299
    assert smoke.fb_bins(smoke.vggish_fb()) == 240


@pytest.mark.parametrize("which,frames,frame_length,n,out_size,bins",
                         [("clap", 1001, 1024, 480000, 2, 299),
                          ("vggish", 998, 400, 160000, 4, 240)])
def test_log_mel_bound_reads_fb_bins(which, frames, frame_length, n, out_size, bins):
    """Phase 3's log-mel bound: the DFT of ``frame_length`` samples into
    the weighed bins in bf16, the 64-mel product over them in f32."""
    fb = _clap_fb() if which == "clap" else smoke.vggish_fb()
    ms, by, ops = smoke.log_mel_bound(64, frames, frame_length, fb, n, out_size)
    bf16 = 2 * 64 * frames * frame_length * 2 * bins
    f32 = 2 * 64 * frames * bins * 64
    assert ops == bf16 + f32
    assert by == "operations"
    assert ms == pytest.approx((bf16 / smoke.PEAK["bf16"] + f32 / smoke.PEAK["f32"]) * 1e3)


@pytest.mark.parametrize("cfg", [HTSAT_BASE, HTSAT_TINY], ids=["base", "tiny"])
def test_frontend_bound_reads_fb_bins(cfg):
    """The fused frontend's DFT and mel product over CLAP's 299 bins."""
    pln = _plan(5 * smoke.SR, smoke.SR, FRAME, HOP, cfg.num_mel_bins, cfg.spec_size,
                cfg.patch_size)
    frames = pln["head_frames"] + pln["n_frames"] - pln["t_tail0"]
    ps, n_mels, rg = cfg.patch_size, cfg.num_mel_bins, pln["ratio"] * pln["gw"]
    bf16 = 64 * (2 * frames * FRAME * 2 * 299 + 2 * ps * rg * pln["n_frames"] * n_mels
                 + 2 * rg * ps * n_mels * pln["fb"] * cfg.embed_dim)
    f32 = 64 * 2 * frames * 299 * n_mels
    assert smoke.frontend_bound(cfg, 64, 5 * smoke.SR)[2] == bf16 + f32
