"""The port's log-mel frontend (plain version, on the CPU) against the JAX
package's XLA path and its fused Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

from nylon_amt_tpu.config import FeatureConfig
from nylon_amt_tpu.ops.mel import MelFrontend as JaxMel
from nylon_amt_tpu.ops.spectrogram_pallas import log_mel_pallas
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import mel as tmel
from nylon_amt_tpu_torch.ops.spectrogram import (
    MMA_N, kernel_bases, log_mel, log_mel_plain)


def _wav(n_samples, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n_samples) * 0.2).astype(np.float32)


def _close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4)
    np.testing.assert_allclose(np.exp(got), np.exp(ref), rtol=1e-4,
                               atol=1e-8)


@pytest.mark.parametrize("n_samples", [16000, 40961])
def test_plain_matches_jax_xla_path(n_samples):
    cfg = FeatureConfig()
    wav = _wav(n_samples)
    ref = np.asarray(JaxMel(cfg)(wav))
    got = tmel.MelFrontend(cfg, "cpu")(wav).numpy()
    _close(got, ref)


@pytest.mark.parametrize("n_samples", [16000, 40961])
def test_plain_matches_pallas_kernel_interpret(n_samples):
    cfg = FeatureConfig()
    wav = _wav(n_samples, seed=1)
    ref = np.asarray(log_mel_pallas(wav, JaxMel(cfg)))   # interpret on CPU
    got = tmel.MelFrontend(cfg, "cpu")(wav).numpy()
    _close(got, ref)


def test_constants_match_jax():
    cfg = FeatureConfig()
    jfe, tfe = JaxMel(cfg), tmel.MelFrontend(cfg, "cpu")
    np.testing.assert_array_equal(tfe.cos_w.numpy(), np.asarray(jfe._cos_w))
    np.testing.assert_array_equal(tfe.sin_w.numpy(), np.asarray(jfe._sin_w))
    np.testing.assert_array_equal(tfe.fb.numpy(), np.asarray(jfe._fb))


def test_frames_and_sample_blocks_match_jax():
    cfg = FeatureConfig()
    jfe, tfe = JaxMel(cfg), tmel.MelFrontend(cfg, "cpu")
    rng = np.random.default_rng(2)
    frames = (rng.standard_normal((5, cfg.fft_bins)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(tfe.features_from_frames(frames).numpy(),
                               np.asarray(jfe.features_from_frames(frames)),
                               atol=2e-4)
    segs = (rng.standard_normal((3, cfg.fft_bins + 4 * cfg.hop_sample))
            * 0.3).astype(np.float32)
    got = tfe.features_from_sample_blocks(segs).numpy()
    assert got.shape == (3, 5, cfg.mel_bins)
    np.testing.assert_allclose(
        got, np.asarray(jfe.features_from_sample_blocks(segs)), atol=2e-4)


def test_reflect_padding_matches_jax():
    cfg = FeatureConfig(pad_mode="reflect")
    wav = _wav(9000, seed=3)
    _close(tmel.MelFrontend(cfg, "cpu")(wav).numpy(),
           np.asarray(JaxMel(cfg)(wav)))


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    cfg = FeatureConfig()
    fe = tmel.MelFrontend(cfg, "cpu")
    wav = torch.from_numpy(_wav(5000, seed=4))
    before = kernels.launches["log_mel"]
    np.testing.assert_array_equal(log_mel(wav, fe).numpy(),
                                  log_mel_plain(wav, fe).numpy())
    assert kernels.launches["log_mel"] == before
    assert fe.kernel_bases is None      # built only for a CUDA frontend


def test_kernel_bases_layout():
    """The bases hold each 8 bins' cos columns, then their sin columns,
    tap-major, for the bins up to the last non-zero filterbank row (padded
    with zero bins to a multiple of 8)."""
    cfg = FeatureConfig()
    cos_w, sin_w = tmel.windowed_bases(cfg)
    fb = tmel.mel_filterbank(cfg.sr, cfg.fft_bins, cfg.mel_bins)
    bases, groups, mel_tab, mel_w = (t.numpy() for t in kernel_bases(
        cos_w, sin_w, fb, torch.device("cpu")))
    n_freqs = cfg.fft_bins // 2 + 1
    last = np.nonzero(fb.any(1))[0].max()
    n_bins = bases.shape[1] // 2
    assert bases.shape == (cfg.fft_bins, 2 * n_bins)
    assert n_bins % MMA_N == 0 and last < n_bins < last + 1 + MMA_N
    cols = bases.T.reshape(n_bins // MMA_N, 2, MMA_N, cfg.fft_bins)
    n = min(n_bins, n_freqs)
    for half, basis in ((0, cos_w), (1, sin_w)):
        rows = cols[:, half].reshape(n_bins, -1)
        np.testing.assert_array_equal(rows[:n], basis[:n])
        assert not rows[n:].any()
    assert groups.dtype == mel_tab.dtype == np.int32
    assert mel_w.dtype == np.float32
