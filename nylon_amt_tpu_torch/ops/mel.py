"""Log-mel spectrogram frontend (PyTorch).

Port of :mod:`nylon_amt_tpu.ops.mel`: the reference's torchaudio frontend
(``MelSpectrogram(sr=16000, n_fft=2048, win_length=2048, hop_length=256,
pad_mode='constant', n_mels=256, norm='slaney')`` then ``log(mel + 1e-8)``)
with the same constants: ``center=True`` padding of ``n_fft // 2``, a
periodic Hann window folded into the cos/sin bases of the one-sided DFT,
the power spectrum, an HTK-scale mel filterbank with Slaney area
normalisation, and the log.

The plain version is three float32 matmuls (run in IEEE float32 on the card,
see :func:`~nylon_amt_tpu_torch.ops.precision.full_f32`). On a CUDA device,
``__call__`` launches the fused log-mel kernel
(:func:`nylon_amt_tpu_torch.ops.spectrogram.log_mel`) instead, and the
streaming entries (``features_from_sample_blocks``,
``features_from_frames``) its segment entry
(:func:`~nylon_amt_tpu_torch.ops.spectrogram.log_mel_segments`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nylon_amt_tpu_torch.config import FeatureConfig
from nylon_amt_tpu_torch.ops.precision import full_f32
from nylon_amt_tpu_torch.ops.spectrogram import (kernel_bases, log_mel,
                                                  log_mel_segments)


def _hz_to_mel_htk(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: float | None = None,
                   norm: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank ``[n_fft // 2 + 1, n_mels]`` (HTK mel
    scale, Slaney area normalisation; torchaudio's ``f_max`` default of
    ``sr // 2``)."""
    if f_max is None:
        f_max = float(sr // 2)
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sr // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None, :]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm: {norm!r}")
    return fb.astype(np.float32)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = win_length if periodic else win_length - 1
    i = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real one-sided DFT bases: cos/sin matrices ``[n_fft//2+1, n_fft]``."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def windowed_bases(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin DFT bases ``[n_fft//2+1, n_fft]`` with the (centred) Hann
    window folded in: ``(C * w) @ frame == C @ (frame * w)``."""
    n_fft = cfg.fft_bins
    window = hann_window(cfg.window_length)
    if cfg.window_length < n_fft:  # torchaudio centres the window in n_fft
        lpad = (n_fft - cfg.window_length) // 2
        window = np.pad(window, (lpad, n_fft - cfg.window_length - lpad))
    cos_b, sin_b = _dft_bases(n_fft)
    return cos_b * window[None, :], sin_b * window[None, :]


class MelFrontend:
    """WAV -> log-mel features on ``device``.

    ``__call__(wav[n_samples]) -> [1 + n_samples // hop, n_mels]`` float32,
    the reference's ``AMT.wav2feature`` layout.
    """

    def __init__(self, cfg: FeatureConfig, device: torch.device | str):
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        cos_w, sin_w = windowed_bases(cfg)
        fb = mel_filterbank(cfg.sr, cfg.fft_bins, cfg.mel_bins)
        self.cos_w = torch.from_numpy(cos_w).to(self.device)   # [n_freqs, n_fft]
        self.sin_w = torch.from_numpy(sin_w).to(self.device)
        self.fb = torch.from_numpy(fb).to(self.device)         # [n_freqs, n_mels]
        # the fused kernel's layout of the same constants (off the CPU:
        # every other device takes the kernel route)
        self.kernel_bases = (kernel_bases(cos_w, sin_w, fb, self.device)
                             if self.device.type != "cpu" else None)

    def frame(self, wav: torch.Tensor) -> torch.Tensor:
        """Centre-pad and cut into overlapping frames ``[n_frames, n_fft]``
        (a strided view of the padded signal)."""
        cfg = self.cfg
        pad = cfg.fft_bins // 2
        if cfg.pad_mode == "constant":
            padded = F.pad(wav, (pad, pad))
        else:
            padded = F.pad(wav[None, None], (pad, pad), mode="reflect")[0, 0]
        return padded.unfold(0, cfg.fft_bins, cfg.hop_sample)

    def compute_from_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """frames ``[..., n_fft]`` -> log-mel ``[..., n_mels]``: two float32
        DFT matmuls, power, the mel matmul and the log."""
        with full_f32():
            re = frames @ self.cos_w.T
            im = frames @ self.sin_w.T
            mel = (re * re + im * im) @ self.fb
        return torch.log(mel + self.cfg.log_offset)

    def features_from_frames(self, frames) -> torch.Tensor:
        """Explicit framing: ``[n, n_fft]`` sample frames -> ``[n, n_mels]``.
        Each output row depends only on its own frame (the streaming entry
        of the reference package). Off the CPU each frame is a segment of
        one frame for the kernel (:func:`log_mel_segments`)."""
        frames = self._tensor(frames)
        if frames.device.type == "cpu":
            return self.compute_from_frames(frames)
        return log_mel_segments(frames.contiguous(), self)[:, 0]

    def features_from_sample_blocks(self, segs) -> torch.Tensor:
        """``[S, seg_len]`` sample segments, frame ``i`` of a segment covering
        samples ``[i*hop, i*hop + n_fft)`` -> ``[S, n_frames, n_mels]``: the
        plain version on the CPU, the log-mel kernel's segment entry (one
        launch) on any other device."""
        return log_mel_segments(self._tensor(segs).contiguous(), self)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def __call__(self, wav) -> torch.Tensor:
        return log_mel(self._tensor(wav), self)
