"""The port's f32-exact products on the CPU: K1 on the FP64 tensor cores
(``csrc/log_mel.cu``), the stem layer's QKV on the CUDA cores, and the float32
attention backward of the layer that the stem feeds.

1. K1 (``csrc/log_mel.cu``), emulated in numpy: the frames and the bases
   widened to float64, exact products, f64 partial sums over chunks of
   ``MMA_K`` taps added in tap order, per group of mel bins as the host cuts
   them (:func:`~nylon_amt_tpu_torch.ops.spectrogram.kernel_bases`), the
   power rounded to f32, each mel bin's f32 sum over its bins in ascending
   order, the f32 log. On seeded loud audio and on a quiet variant it holds
   ``chip_smoke.py`` (b)'s 2e-4 from a float64 truth, is no further from the
   plain f32 version (``log_mel_plain``) and from the JAX package's frontend
   than they are from that truth + 2e-4.
2. The host's cut of the filterbank: every mel bin's range is its first to
   its last non-zero row, each group's bins start on a multiple of 8 and
   fit a block, the groups cover every mel bin once and only the bins from
   the first to the last non-zero row (each at most twice); a filterbank
   whose row 0 is non-zero starts at bin 0.
3. The stem QKV (``gemm_bias_ffma_kernel``), emulated: one f32 fmaf chain
   over k ascending from 0 an output, then the f32 bias. Within (q)'s 2e-5
   of max(1, max |plain f32 twin|) of ``gemm_bias_plain`` and of the JAX
   package's ``_matmul``, at hid 64 and 256 with ragged M. The same held
   for f64 sums of the exact products (the FP64 tensor cores' arithmetic),
   closer to a float64 truth than the twin: the QKV alone does not tell
   the two apart, the stem layer on the card does (PERF.md).
4. The wrappers hand the loader their arguments on meta tensors, and refuse
   what the kernels do not take before it.
5. The layer that the stem feeds, and only that one, takes the float32
   attention backward whose scores are recomputed on FFMA
   (``nylon_attention_bwd_ffma_f32``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu.config import FeatureConfig as JaxFeatureConfig
from nylon_amt_tpu.ops import layer_fused as jlf
from nylon_amt_tpu.ops.mel import MelFrontend as JaxMel
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.config import FeatureConfig
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt
from nylon_amt_tpu_torch.ops import mel as tmel
from nylon_amt_tpu_torch.ops.spectrogram import (
    BLOCK_BINS, MMA_N, kernel_bases, log_mel, log_mel_plain, mel_groups)

from test_torch_gemm_f32 import _meta_enc, calls, meta_route  # noqa: F401

K1_ATOL = 2e-4  # chip_smoke.py (b): log-mel from a float64 truth
REL = 2e-5      # chip_smoke.py (q): of max(1, max |plain f32|)
MMA_K = 16      # taps of one mma.sync (kMmaK in csrc/log_mel.cu)
SR = 16000


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ K1 --

def _audio(seconds, seed, noise):
    """Decaying sines at a few pitches, a new note every 0.25 s, over a
    noise floor (chip_smoke.py's synthetic audio, shorter)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    wav = noise * rng.standard_normal(n)
    pitches = (48, 55, 60, 64, 67, 72, 76)
    for i, start in enumerate(np.arange(0.0, seconds - 0.5, 0.25)):
        f = 440.0 * 2 ** ((pitches[i % len(pitches)] - 69) / 12)
        s = int(start * SR)
        tt = t[s:s + SR] - start
        wav[s:s + SR] += 0.2 * np.exp(-3.0 * tt) * np.sin(2 * np.pi * f * tt)
    return wav.astype(np.float32)


def _frames(wav, cfg):
    pad = cfg.fft_bins // 2
    padded = np.pad(wav, (pad, pad))
    idx = (np.arange(1 + wav.size // cfg.hop_sample)[:, None]
           * cfg.hop_sample + np.arange(cfg.fft_bins)[None])
    return padded[idx]


def emulate_log_mel(wav, cfg):
    """K1's arithmetic in numpy (see the module docstring, item 1)."""
    cos_w, sin_w = tmel.windowed_bases(cfg)
    fb = tmel.mel_filterbank(cfg.sr, cfg.fft_bins, cfg.mel_bins)
    bases, groups, mel_tab, mel_w = (t.numpy() for t in kernel_bases(
        cos_w, sin_w, fb, torch.device("cpu")))
    frames = _frames(wav, cfg).astype(np.float64)
    n_fft = cfg.fft_bins
    width = 2 * BLOCK_BINS
    cols = np.zeros((n_fft, bases.shape[1] + width))
    cols[:, :bases.shape[1]] = bases
    out = np.empty((frames.shape[0], cfg.mel_bins), np.float32)
    offset = np.float32(cfg.log_offset)
    for bin0, _, mel_lo, mel_hi in groups:
        b = cols[:, 2 * bin0: 2 * bin0 + width]
        acc = np.zeros((frames.shape[0], width))
        for k0 in range(0, n_fft, MMA_K):
            acc += frames[:, k0:k0 + MMA_K] @ b[k0:k0 + MMA_K]
        acc = acc.reshape(-1, BLOCK_BINS // MMA_N, 2, MMA_N)
        re, im = acc[:, :, 0].reshape(-1, BLOCK_BINS), \
            acc[:, :, 1].reshape(-1, BLOCK_BINS)
        power = (re * re + im * im).astype(np.float32)
        for m in range(mel_lo, mel_hi):
            lo, cnt, off = mel_tab[m]
            s = np.zeros(frames.shape[0], np.float32)
            for q in range(cnt):
                s = s + power[:, lo - bin0 + q] * mel_w[off + q]
            out[:, m] = np.log(s + offset)
    return out


def truth_log_mel(wav, cfg):
    cos_w, sin_w = tmel.windowed_bases(cfg)
    fb = tmel.mel_filterbank(cfg.sr, cfg.fft_bins, cfg.mel_bins)
    frames = _frames(wav, cfg).astype(np.float64)
    re = frames @ cos_w.astype(np.float64).T
    im = frames @ sin_w.astype(np.float64).T
    return np.log((re * re + im * im) @ fb.astype(np.float64)
                  + cfg.log_offset)


@pytest.mark.parametrize("noise", [0.05, 0.01], ids=["loud", "quiet"])
def test_k1_emulation_holds_the_float64_gate(noise):
    cfg = FeatureConfig()
    wav = _audio(2.5, 3, noise)
    got = emulate_log_mel(wav, cfg)
    truth = truth_log_mel(wav, cfg)
    plain = log_mel_plain(torch.from_numpy(wav),
                          tmel.MelFrontend(cfg, "cpu")).numpy()
    jax_out = np.asarray(JaxMel(JaxFeatureConfig())(wav))
    assert got.shape == truth.shape == plain.shape == jax_out.shape
    err = np.abs(got - truth).max()
    assert err <= K1_ATOL, err
    for ref in (plain, jax_out):
        assert np.abs(got - ref).max() <= np.abs(ref - truth).max() + K1_ATOL


# ---------------------------------------------------- the host's cut --

def _check_groups(fb):
    groups, mel_tab, mel_w = mel_groups(fb)
    nz = fb != 0
    covered = np.zeros(fb.shape[1], int)
    computed = np.zeros(fb.shape[0] + BLOCK_BINS, int)
    for bin0, n_bins, mel_lo, mel_hi in groups:
        assert bin0 % MMA_N == 0 and 0 < n_bins <= BLOCK_BINS
        covered[mel_lo:mel_hi] += 1
        computed[bin0: bin0 + n_bins] += 1
        for m in range(mel_lo, mel_hi):
            lo, cnt, off = mel_tab[m]
            assert bin0 <= lo and lo + cnt <= bin0 + n_bins
    assert (covered == 1).all()
    for m in range(fb.shape[1]):
        rows = np.nonzero(nz[:, m])[0]
        lo, cnt, off = mel_tab[m]
        assert (lo, lo + cnt - 1) == (rows[0], rows[-1])
        np.testing.assert_array_equal(mel_w[off: off + cnt],
                                      fb[lo: lo + cnt, m])
    used = np.nonzero(nz.any(1))[0]
    first, last = used[0], used[-1]
    assert groups[0][0] == first // MMA_N * MMA_N
    assert computed[first: last + 1].min() >= 1 and computed.max() <= 2
    assert not computed[last + 1:].any()
    return groups


def test_groups_take_the_filterbank_range():
    cfg = FeatureConfig()
    fb = tmel.mel_filterbank(cfg.sr, cfg.fft_bins, cfg.mel_bins)
    groups = _check_groups(fb)
    # bins 1 .. 1024 of 1025: bin 0 has no mel weight
    assert np.nonzero(fb.any(1))[0][[0, -1]].tolist() == [1, 1024]
    assert groups[0][0] == 0 and groups[-1][0] + groups[-1][1] == 1025


def test_groups_with_a_nonzero_row_0():
    cfg = FeatureConfig()
    fb = tmel.mel_filterbank(cfg.sr, cfg.fft_bins, cfg.mel_bins)
    fb[0, 0] = 0.5
    groups = _check_groups(fb)
    assert groups[0][0] == 0


def test_groups_refuse_a_mel_bin_wider_than_a_block():
    fb = np.zeros((300, 4), np.float32)
    fb[3: 3 + BLOCK_BINS, 1] = 1.0      # 128 bins from bin 3: past 8 + 120
    with pytest.raises(ValueError, match="spans"):
        mel_groups(fb)


# ------------------------------------------------------------ stem QKV --

def _qkv_inputs(m, hid, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, hid)).astype(np.float32)
    w = (rng.standard_normal((hid, 3 * hid)) / np.sqrt(hid)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(3 * hid)).astype(np.float32)
    return a, w, b


def emulate_qkv(a, w, b, f64_sums=False):
    """The kernel's arithmetic: ``acc = fmaf(a[:, k], w[k], acc)`` for k
    ascending (the product and the sum exact in float64, then one rounding
    to f32), then the f32 bias; with ``f64_sums`` the FP64 tensor cores'
    instead: f64 sums of the exact products in chunks of MMA_K, one
    rounding."""
    a64, w64 = a.astype(np.float64), w.astype(np.float64)
    if f64_sums:
        acc = np.zeros((a.shape[0], w.shape[1]))
        for k0 in range(0, a.shape[1], MMA_K):
            acc += a64[:, k0:k0 + MMA_K] @ w64[k0:k0 + MMA_K]
        return acc.astype(np.float32) + b
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc + a64[:, k, None] * w64[None, k]).astype(np.float32)
    return acc + b


@pytest.mark.parametrize("f64_sums", [False, True], ids=["ffma", "f64"])
@pytest.mark.parametrize("hid", [64, 256])
def test_qkv_emulation_against_the_twins(hid, f64_sums):
    a, w, b = _qkv_inputs(203, hid, hid)
    got = emulate_qkv(a, w, b, f64_sums)
    plain = tlf.gemm_bias_plain(torch.from_numpy(a), torch.from_numpy(w),
                                torch.from_numpy(b)).numpy()
    jax_out = np.asarray(jlf._matmul(jnp.asarray(a), jnp.asarray(w),
                                     jnp.asarray(b)))
    truth = a.astype(np.float64) @ w.astype(np.float64) + b
    for ref in (plain, jax_out):
        top = max(1.0, np.abs(ref).max())
        assert np.abs(got - ref).max() / top <= REL
    top = max(1.0, np.abs(truth).max())
    d_got = np.abs(got - truth).max() / top
    d_plain = np.abs(plain - truth).max() / top
    # f64 sums round once: closer to the truth than any f32 order
    assert d_got <= (d_plain if f64_sums else 2 * d_plain + 1e-7)


# ---------------------------------------------------------- the wrappers --

def test_gemm_ffma_reaches_the_loader_and_refuses_bad_geometry(meta_route):
    def z(*s):
        return torch.empty(s, device="meta")

    tlf._gemm_ffma(z(203, 96), z(96, 288), z(288))
    (name, args), = meta_route
    assert name == "nylon_gemm_bias_ffma_f32" and args[4:8] == (203, 288,
                                                                  96, 0)
    meta_route.clear()
    for a, w, bias in ((z(203, 96), z(96, 290), z(290)),    # N % 4
                       (z(203, 96), z(64, 288), z(288)),    # K of w
                       (z(203, 96), z(96, 288), z(96)),     # the bias
                       (z(203, 98), z(98, 288), z(288))):   # K % 4
        with pytest.raises(ValueError):
            tlf._gemm_ffma(a, w, bias)
    with pytest.raises(ValueError):
        tlf._gemm_ffma(z(203, 96).bfloat16(), z(96, 288).bfloat16(), z(288))
    assert meta_route == []


def _meta_frontend(cfg):
    fe = tmel.MelFrontend(cfg, "cpu")
    cos_w, sin_w = tmel.windowed_bases(cfg)
    fb = tmel.mel_filterbank(cfg.sr, cfg.fft_bins, cfg.mel_bins)
    fe.kernel_bases = tuple(t.to("meta") for t in kernel_bases(
        cos_w, sin_w, fb, torch.device("cpu")))
    return fe


def test_log_mel_reaches_the_loader_and_refuses_bad_config(meta_route):
    cfg = FeatureConfig()
    fe = _meta_frontend(cfg)
    wav = torch.empty(40961, device="meta")
    kernels.reset_launches()
    out = log_mel(wav, fe)
    (name, args), = meta_route
    bases, groups = fe.kernel_bases[:2]
    n_frames = 1 + 40961 // cfg.hop_sample
    assert name == "nylon_log_mel" and out.shape == (n_frames, cfg.mel_bins)
    assert args[1] == 40961 and args[3] == bases.shape[1] == 2064
    assert args[5] == groups.shape[0] and args[9:13] == (
        n_frames, cfg.fft_bins, cfg.hop_sample, cfg.mel_bins)
    assert kernels.launches["log_mel"] == 1
    meta_route.clear()
    for bad in (FeatureConfig(pad_mode="reflect"), FeatureConfig(mel_bins=128),
                FeatureConfig(fft_bins=2000, window_length=2000),
                FeatureConfig(hop_sample=200)):
        fe_bad = _meta_frontend(bad)
        with pytest.raises(ValueError, match="log-mel kernel"):
            log_mel(wav, fe_bad)
    fe.kernel_bases = None                   # a CPU frontend, a meta wav
    with pytest.raises(ValueError, match="frontend lives on"):
        log_mel(wav, fe)
    assert meta_route == [] and kernels.launches["log_mel"] == 1


# ------------------------------------- the stem-fed attention backward --

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_only_the_stem_fed_layer_takes_the_ffma_score_backward(meta_route,
                                                                dt):
    hid, pf, heads, n = 64, 128, 2, 2
    x = torch.empty((n, 256, hid), dtype=dt, device="meta")
    p32 = _meta_enc(hid, pf, torch.float32)
    bwd = ("nylon_attention_bwd", "nylon_attention_bwd_f32",
           "nylon_attention_bwd_ffma_f32")
    for stem in (True, False):
        meta_route.clear()
        tlt.encoder_layer_train_bwd_cuda(x, p32, 3, x, heads, 0.1, True,
                                         stem=stem)
        got = [name for name, _ in meta_route if name in bwd]
        want = ("nylon_attention_bwd_ffma_f32" if stem and dt == torch.float32
                else kernels.entry("nylon_attention_bwd", dt))
        assert got == [want]
        # the forward launches no backward
        meta_route.clear()
        tlt.encoder_layer_train_cuda(x, p32, 3, heads, 0.1, True, stem=stem)
        assert not [name for name, _ in meta_route if name in bwd]
    # the per-site attention backward (K10) keeps the 3xTF32 scores
    meta_route.clear()
    q = torch.empty((n * 256, hid), dtype=dt, device="meta")
    tlt._attention_bwd(q, q, q, q, q, q, q, n, heads, 3, 0.0, 0)
    assert [name for name, _ in meta_route] == [
        kernels.entry("nylon_attention_bwd", dt)]
