"""Windowed-sinc sample-rate conversion (host-side, numpy).

Equivalent to ``torchaudio.transforms.Resample`` with its defaults
(``sinc_interp_hann``, ``lowpass_filter_width=6``, ``rolloff=0.99``), which is
what the reference uses to bring arbitrary-rate WAVs to 16 kHz
(``hftt_code/model/amt.py:57-58``). Implemented as a polyphase filterbank:
one bank of sinc kernels per output phase, evaluated as a single matmul over
strided input frames.

Copy of the JAX package's module of the same name: importing that one
would load JAX through its package ``__init__``. A test holds the two
equal.
"""

from __future__ import annotations

import math

import numpy as np


def _resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple[np.ndarray, int]:
    """Build the polyphase kernel bank ``[new_freq, kernel_width]``.

    Follows the classic bandlimited-interpolation construction (Smith, CCRMA;
    the same algorithm torchaudio implements): for output phase ``i`` the
    kernel taps sit at times ``(-i/new + n/orig)`` scaled by the cutoff.
    """
    assert lowpass_filter_width > 0
    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t_pi = t * np.pi
    kernel = np.where(t_pi == 0.0, 1.0, np.sin(t_pi) / np.where(t_pi == 0.0, 1.0, t_pi))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel.astype(np.float32), width


def resample(
    wav: np.ndarray,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> np.ndarray:
    """Resample a 1-D float waveform from ``orig_freq`` to ``new_freq``."""
    wav = np.asarray(wav, dtype=np.float32)
    if orig_freq == new_freq:
        return wav
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = orig_freq // g, new_freq // g

    kernel, width = _resample_kernel(orig, new, lowpass_filter_width, rolloff)
    n_in = wav.shape[0]
    target_len = int(math.ceil(new * n_in / orig))

    # Pad so every kernel window [i*orig - width, i*orig + width + orig) is valid.
    n_blocks = int(math.ceil(n_in / orig))
    k_width = kernel.shape[1]
    padded = np.pad(wav, (width, width + orig + n_blocks * orig - n_in))
    # Strided frames: frame i covers input samples [i*orig, i*orig + k_width).
    stride = padded.strides[0]
    frames = np.lib.stride_tricks.as_strided(
        padded, shape=(n_blocks, k_width), strides=(orig * stride, stride)
    )
    # out[i, p] = output sample i*new + p
    out = frames @ kernel.T
    return out.reshape(-1)[:target_len].astype(np.float32)
