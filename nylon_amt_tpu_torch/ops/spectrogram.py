"""Fused log-mel spectrogram (K1): wrapper of ``csrc/log_mel.cu`` and its
plain version.

Port of :func:`nylon_amt_tpu.ops.spectrogram_pallas.log_mel_pallas`. The
kernel reads raw samples and writes ``[1 + n // hop, n_mels]`` float32
log-mel; it does the centre padding, framing, windowed DFT, power, mel
projection and log itself (design notes in the CUDA source).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nylon_amt_tpu_torch import kernels

FREQ_CHUNK = 64   # frequencies per kernel pass (kFK in csrc/log_mel.cu)
KERNEL_MELS = 256  # mel bins the kernel's register tile covers (kMels)
TAP_CHUNK = 32    # DFT taps per pipeline stage (kTK)


def kernel_bases(cos_w: np.ndarray, sin_w: np.ndarray, fb: np.ndarray,
                 device: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's layout of the frontend constants: windowed cos/sin bases
    transposed to ``[n_fft, n_freq_pad]`` (frequency contiguous) and the
    filterbank ``[n_freq_pad, n_mels]``, with the frequencies zero-padded to
    a multiple of :data:`FREQ_CHUNK` (zero rows add nothing to the mel
    sums)."""
    n_freqs, n_fft = cos_w.shape
    n_pad = math.ceil(n_freqs / FREQ_CHUNK) * FREQ_CHUNK
    wc_t = np.zeros((n_fft, n_pad), np.float32)
    ws_t = np.zeros((n_fft, n_pad), np.float32)
    fb_pad = np.zeros((n_pad, fb.shape[1]), np.float32)
    wc_t[:, :n_freqs] = cos_w.T
    ws_t[:, :n_freqs] = sin_w.T
    fb_pad[:n_freqs] = fb
    return tuple(torch.from_numpy(a).to(device) for a in (wc_t, ws_t, fb_pad))


def log_mel_plain(wav: torch.Tensor, frontend) -> torch.Tensor:
    """Plain version: explicit frames, then three float32 matmuls and the
    log (:meth:`MelFrontend.compute_from_frames`)."""
    return frontend.compute_from_frames(frontend.frame(wav))


def log_mel(wav: torch.Tensor, frontend) -> torch.Tensor:
    """``wav [n]`` float32 -> log-mel ``[1 + n // hop, n_mels]``.

    A CPU tensor takes the plain version; any other device launches the
    fused kernel or raises.
    """
    if wav.device.type == "cpu":
        return log_mel_plain(wav, frontend)
    cfg = frontend.cfg
    kernels.check_cuda("log_mel: wav", wav, torch.float32, ndim=1)
    if cfg.pad_mode != "constant":
        raise ValueError("log-mel kernel: only pad_mode='constant' (zero "
                         "centre padding) is implemented")
    if cfg.mel_bins != KERNEL_MELS or cfg.fft_bins % TAP_CHUNK:
        raise ValueError(f"log-mel kernel: needs {KERNEL_MELS} mel bins and "
                         f"n_fft % {TAP_CHUNK} == 0, got {cfg.mel_bins}, "
                         f"{cfg.fft_bins}")
    if (frontend.kernel_bases is None
            or frontend.kernel_bases[0].device != wav.device):
        raise ValueError(f"log-mel kernel: frontend lives on "
                         f"{frontend.device}, wav on {wav.device}")
    wc_t, ws_t, fb = frontend.kernel_bases
    n = wav.shape[0]
    n_frames = 1 + n // cfg.hop_sample
    out = torch.empty((n_frames, cfg.mel_bins), dtype=torch.float32,
                      device=wav.device)
    with torch.cuda.device(wav.device):
        kernels.call("nylon_log_mel", wav.data_ptr(), n, wc_t.data_ptr(),
                     ws_t.data_ptr(), fb.data_ptr(), out.data_ptr(), n_frames,
                     cfg.fft_bins, cfg.hop_sample, wc_t.shape[1],
                     cfg.mel_bins, cfg.log_offset, kernels.stream_of(wav))
    kernels.launches["log_mel"] += 1
    return out
