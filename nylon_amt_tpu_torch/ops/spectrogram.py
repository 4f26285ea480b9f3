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

BLOCK_BINS = 128   # bins a kernel block covers (kBins in csrc/log_mel.cu)
MMA_N = 8          # the DFT mma's n: a group's first bin is a multiple of it
KERNEL_MELS = 256  # the mel bins of the configurations the kernel is held at
TAP_CHUNK = 32     # DFT taps per pipeline stage (kBK in csrc/log_mel.cu)


def mel_groups(fb: np.ndarray):
    """The kernel's cut of the filterbank ``fb [n_freqs, n_mels]`` into
    groups of consecutive mel bins, each held by one block row: returns
    ``(groups, mel_tab, mel_w)``.

    ``mel_tab[m] = (lo, cnt, off)``: mel bin ``m`` gathers bins ``lo ..
    lo + cnt - 1`` (its first to its last non-zero row; ``cnt`` 0 for an
    empty column) with weights ``mel_w[off : off + cnt]``. ``groups[y] =
    (bin0, n_bins, mel_lo, mel_hi)``: the block row's mel bins ``mel_lo ..
    mel_hi - 1`` reach bins ``bin0 .. bin0 + n_bins - 1``, ``bin0`` a multiple
    of :data:`MMA_N` and ``n_bins <= BLOCK_BINS``; groups are cut greedily in
    mel order, so only the bins from the first to the last non-zero row are
    computed, each at most twice (at a group boundary)."""
    n_freqs, n_mels = fb.shape
    nz = fb != 0
    mel_tab = np.zeros((n_mels, 3), np.int32)
    weights = []
    off = 0
    for m in range(n_mels):
        rows = np.nonzero(nz[:, m])[0]
        if rows.size:
            lo, hi = int(rows[0]), int(rows[-1])
            if hi - lo + 1 > BLOCK_BINS - (lo % MMA_N):
                raise ValueError(f"log-mel kernel: mel bin {m} spans "
                                 f"{hi - lo + 1} bins, more than a block's "
                                 f"{BLOCK_BINS}")
            weights.append(fb[lo: hi + 1, m].astype(np.float32))
            mel_tab[m] = lo, hi - lo + 1, off
            off += hi - lo + 1
    groups = []
    m = 0
    while m < n_mels:
        bin0, last, m0 = None, None, m
        while m < n_mels:
            lo, cnt = int(mel_tab[m, 0]), int(mel_tab[m, 1])
            if cnt:
                start = bin0 if bin0 is not None else lo // MMA_N * MMA_N
                if lo < start or lo + cnt > start + BLOCK_BINS:
                    break
                bin0, last = start, max(last or 0, lo + cnt)
            m += 1
        groups.append((bin0 or 0, (last or 0) - (bin0 or 0), m0, m))
    # (one zero weight for a filterbank of empty columns: no empty buffer)
    w = (np.concatenate(weights) if weights
         else np.zeros(1, np.float32))
    return np.asarray(groups, np.int32), mel_tab, w


def kernel_bases(cos_w: np.ndarray, sin_w: np.ndarray, fb: np.ndarray,
                 device: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's layout of the frontend constants: ``(bases, groups,
    mel_tab, mel_w)``. ``bases [n_fft, 2 x n_bins]`` holds the windowed
    cos and sin bases of bins ``0 .. n_bins - 1`` (up to the last non-zero
    filterbank row, padded with zero bins to a multiple of :data:`MMA_N`),
    tap-major, each 8 bins' cos columns followed by their sin columns; the
    rest is :func:`mel_groups` of ``fb``."""
    n_freqs, n_fft = cos_w.shape
    groups, mel_tab, mel_w = mel_groups(fb)
    last = int(max(g[0] + g[1] for g in groups))
    n_bins = max(MMA_N, math.ceil(last / MMA_N) * MMA_N)
    cols = np.zeros((n_bins // MMA_N, 2, MMA_N, n_fft), np.float32)
    n = min(n_freqs, n_bins)
    for half, basis in ((0, cos_w), (1, sin_w)):
        b = np.zeros((n_bins, n_fft), np.float32)
        b[:n] = basis[:n]
        cols[:, half] = b.reshape(n_bins // MMA_N, MMA_N, n_fft)
    bases = np.ascontiguousarray(cols.reshape(2 * n_bins, n_fft).T)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (bases, groups, mel_tab, mel_w))


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
    if (cfg.mel_bins != KERNEL_MELS or cfg.fft_bins % TAP_CHUNK
            or cfg.hop_sample % TAP_CHUNK):
        raise ValueError(f"log-mel kernel: needs {KERNEL_MELS} mel bins, "
                         f"n_fft % {TAP_CHUNK} == 0 and hop % {TAP_CHUNK} == "
                         f"0, got {cfg.mel_bins}, {cfg.fft_bins}, "
                         f"{cfg.hop_sample}")
    if (frontend.kernel_bases is None
            or frontend.kernel_bases[0].device != wav.device):
        raise ValueError(f"log-mel kernel: frontend lives on "
                         f"{frontend.device}, wav on {wav.device}")
    bases, groups, mel_tab, mel_w = frontend.kernel_bases
    n = wav.shape[0]
    n_frames = 1 + n // cfg.hop_sample
    out = torch.empty((n_frames, cfg.mel_bins), dtype=torch.float32,
                      device=wav.device)
    with torch.cuda.device(wav.device):
        kernels.call("nylon_log_mel", wav.data_ptr(), n, bases.data_ptr(),
                     bases.shape[1], groups.data_ptr(), groups.shape[0],
                     mel_tab.data_ptr(), mel_w.data_ptr(), out.data_ptr(),
                     n_frames, cfg.fft_bins, cfg.hop_sample, cfg.mel_bins,
                     cfg.log_offset, kernels.stream_of(wav))
    kernels.launches["log_mel"] += 1
    return out
