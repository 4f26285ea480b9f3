"""WAV loading (self-contained replacement for ``torchaudio.load``).

The reference loads WAVs via torchaudio, averages channels to mono, and
resamples to the config rate (``hftt_code/model/amt.py:55-58``). This module
reproduces that with scipy's RIFF reader plus our sinc resampler, returning
float32 in [-1, 1] with torchaudio's integer-scaling conventions.

Copy of the JAX package's module of the same name: importing that one
would load JAX through its package ``__init__``. A test holds the two
equal.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

from nylon_amt_tpu_torch.ops.resample import resample

_INT_SCALE = {np.dtype(np.int16): 1 << 15,
              np.dtype(np.int32): 1 << 31,
              np.dtype(np.uint8): 1 << 7}


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples ``[n, channels]``-squeezed, sr)."""
    sr, data = wavfile.read(path)
    dt = data.dtype
    if dt in _INT_SCALE:
        if dt == np.dtype(np.uint8):  # 8-bit WAV is unsigned, offset binary
            data = data.astype(np.float32) - 128.0
        data = data.astype(np.float32) / _INT_SCALE[dt]
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def load_mono(path: str, target_sr: int) -> np.ndarray:
    """WAV -> mono float32 at ``target_sr`` (channel mean, sinc resample).

    Matches reference ``amt.py:55-58`` (torch.mean over channels, then
    torchaudio Resample).
    """
    data, sr = load_wav(path)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != target_sr:
        data = resample(data, sr, target_sr)
    return data


def save_wav(path: str, data: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] samples as 16-bit PCM (test/synthesis helper)."""
    clipped = np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (clipped * 32767.0).astype(np.int16))
