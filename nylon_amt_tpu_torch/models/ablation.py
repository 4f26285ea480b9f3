"""Ablation model variants (reference ``model/model_spec2midi_ablation.py``).

Port of :mod:`nylon_amt_tpu.models.ablation`. The paper's ablation grid
crosses two encoders with three decoders (1FDN = cnntime + cafreq, 1FDT =
cnntime + cafreq_satime, 1FLT = cnntime + linear_satime, 2FDT = cnnblock +
cafreq_satime). The main combinations are :class:`~nylon_amt_tpu_torch.
models.hft.HFT`; :class:`AblationModel` composes the others from

* :class:`CNNBlockEncoder` (``cnnblock_safreq``, ref
  ``Encoder_CNNblock_SAfreq:134-266``): four conv blocks (48/64/96/128
  channels, two 3x3 convs + BatchNorm + ReLU each, frequency-halving
  average pool, dropout 0.1), 65-frame windows reshaped to 256 pseudo-bins
  x 520 features, then the frequency transformer;
* the main :class:`~nylon_amt_tpu_torch.models.hft.Encoder`
  (``cnntime_safreq``), the main :class:`~nylon_amt_tpu_torch.models.hft.
  Decoder` (``cafreq_satime``, ``cafreq``; no attention map), or
  :class:`LinearSAtimeDecoder` (``linear_satime``, ref
  ``Decoder_linear_SAtime:457-545``: a Linear(n_bin -> n_note) over the bin
  axis in place of the cross attention, then stage 2).

Every attention site runs the per-site kernels (K10, K12) through the
shared modules; the convolutions, BatchNorm and the bin projection are
PyTorch ops (XLA graphs in the JAX package). The modules carry the
reference's attribute names (``encoder_spec2midi.conv_{1..4}.{0,1,3,4}``,
``decoder_spec2midi.fc_convert``), so reference ``.dat`` files load with
``strict=True``; the BatchNorm running statistics are buffers.

BatchNorm follows flax's (``nn.BatchNorm(momentum=0.9, dtype=float32)``),
not torch's ``BatchNorm2d`` (whose modules here only hold the weights and
statistics): f32 statistics of the compute-dtype conv output, the biased
batch variance ``E[x^2] - E[x]^2`` (clipped at 0) both to normalise and to
update the running variance, running = 0.9 running + 0.1 batch. Training
(a per-site forward with seeds) normalises by the batch and updates the
buffers in place (``num_batches_tracked`` counts, as torch's would);
otherwise the running statistics normalise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.models.hft import (
    Decoder,
    Encoder,
    EncoderLayer,
    Model,
    Sites,
    _embed,
    _linear,
    stage1_heads,
    stage2,
)
from nylon_amt_tpu_torch.ops.precision import full_f32

_CHANNELS = (48, 64, 96, 128)
_BN_MOMENTUM = 0.9        # flax's (torch's momentum 0.1)
_BN_EPS = 1e-5


def _conv(x, conv: nn.Conv2d, dt):
    """flax ``nn.Conv(dtype=dt)``: operands in ``dt``, f32 sums, the output
    rounded to ``dt`` before the bias add."""
    with full_f32():
        y = F.conv2d(x.to(dt).float(), conv.weight.to(dt).float(), padding=1)
    return y.to(dt) + conv.bias.to(dt)[:, None, None]


def _batch_norm(x, bn: nn.BatchNorm2d, train: bool):
    """flax ``nn.BatchNorm`` over the (batch, time, freq) axes of NCHW
    ``x``, in f32."""
    xf = x.float()
    if train:
        mean = xf.mean((0, 2, 3))
        var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean
                                  + (1 - _BN_MOMENTUM) * mean)
            bn.running_var.copy_(_BN_MOMENTUM * bn.running_var
                                 + (1 - _BN_MOMENTUM) * var)
            bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + _BN_EPS) * bn.weight
    return (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]


def conv_block(x, block: nn.Sequential, dt, train: bool):
    """JAX's ``ConvBlock`` on NCHW ``x``: (3x3 conv, BatchNorm, ReLU) twice,
    then the frequency-halving average pool; f32 out."""
    for conv, bn in ((block[0], block[1]), (block[3], block[4])):
        x = torch.relu(_batch_norm(_conv(x, conv, dt), bn, train))
    return x.reshape(*x.shape[:3], -1, 2).mean(-1)


class CNNBlockEncoder(nn.Module):
    """``Encoder_CNNblock_SAfreq`` (ref ``:134-266``). ``dropout_convblock``
    is the rate after each conv block (0.1 whatever the model's dropout, as
    the JAX encoder's default)."""

    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        self.dropout_convblock = 0.1
        self.n_proc = 2 * config.input.margin_b + 1
        c_in = 1
        for b, ch in enumerate(_CHANNELS, 1):
            # nn.Sequential indices 0/3 = Conv2d, 1/4 = BatchNorm2d (the
            # reference's keys)
            setattr(self, f"conv_{b}", nn.Sequential(
                nn.Conv2d(c_in, ch, 3, padding=1), nn.BatchNorm2d(ch),
                nn.ReLU(), nn.Conv2d(ch, ch, 3, padding=1),
                nn.BatchNorm2d(ch), nn.ReLU()))
            c_in = ch
        self.tok_embedding_freq = nn.Linear(self.n_proc * 8, m.hid_dim)
        self.pos_embedding_freq = nn.Embedding(config.feature.n_bins,
                                               m.hid_dim)
        self.layers_freq = nn.ModuleList(
            EncoderLayer(m.hid_dim, m.enc_head, m.pf_dim, f"enc.{i}")
            for i in range(m.enc_layer))

    def forward(self, spec, config: Config, dt, sites: Sites):
        B, n_bin, _ = spec.shape
        n_frame, hid = config.input.num_frame, config.model.hid_dim
        x = spec.transpose(1, 2)[:, None]         # NCHW [B, 1, time, freq]
        for b in range(1, len(_CHANNELS) + 1):
            x = conv_block(x, getattr(self, f"conv_{b}"), dt, sites.train)
            x = sites.drop(x, "conv", b, rate=self.dropout_convblock)
        # [B, total, n_bin/16, 128] -> 65-frame windows [B, nf, 65, 16, 128]
        # -> the reference's [B, nf, 16, 128, 65] split into (16, 8) channels
        # -> [B, nf, n_bin, 8 * 65]
        x = x.permute(0, 2, 3, 1)
        idx = (torch.arange(n_frame, device=x.device)[:, None]
               + torch.arange(self.n_proc, device=x.device)[None, :])
        win = x[:, idx].permute(0, 1, 3, 4, 2)
        win = win.reshape(B, n_frame, n_bin // 16, 16, 8, self.n_proc)
        win = win.reshape(B, n_frame, n_bin, 8 * self.n_proc)
        emb = _linear(win, self.tok_embedding_freq, dt)
        h = _embed(emb.reshape(B * n_frame, n_bin, hid),
                   self.pos_embedding_freq.weight, hid, dt, sites, "enc.0")
        for layer in self.layers_freq:
            h = layer(h, dt, sites)
        return h                                   # [B*n_frame, n_bin, hid]


class LinearSAtimeDecoder(nn.Module):
    """Cross attention replaced by Linear(n_bin -> n_note) over the bin
    axis, then stage 2 (ref ``Decoder_linear_SAtime:457-545``)."""

    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        hid, n_vel = m.hid_dim, config.midi.num_velocity
        self.fc_convert = nn.Linear(config.feature.n_bins,
                                    config.midi.num_note)
        self.fc_onset_freq = nn.Linear(hid, 1)
        self.fc_offset_freq = nn.Linear(hid, 1)
        self.fc_mpe_freq = nn.Linear(hid, 1)
        self.fc_velocity_freq = nn.Linear(hid, n_vel)
        self.pos_embedding_time = nn.Embedding(config.input.num_frame, hid)
        self.layers_time = nn.ModuleList(
            EncoderLayer(hid, m.dec_head, m.pf_dim, f"time.{i}")
            for i in range(m.dec_layer))
        self.fc_onset_time = nn.Linear(hid, 1)
        self.fc_offset_time = nn.Linear(hid, 1)
        self.fc_mpe_time = nn.Linear(hid, 1)
        self.fc_velocity_time = nn.Linear(hid, n_vel)

    def forward(self, enc, B, dt, sites: Sites):
        n, n_bin, hid = enc.shape
        n_frame = n // B
        # bins -> notes: f32 sums, rounded to dt, then the bias in dt
        with full_f32():
            trg = torch.matmul(enc.to(dt).transpose(1, 2).float(),
                               self.fc_convert.weight.t().to(dt).float())
        trg = trg.to(dt) + self.fc_convert.bias.to(dt)
        trg = trg.transpose(1, 2)                  # [B*n_frame, n_note, hid]
        out = stage1_heads(self, trg, B, n_frame, dt)
        return stage2(self, trg, B, n_frame, dt, sites, out)


class AblationModel(Model):
    """Encoder x decoder composition of the ablation grid (the
    combinations that :class:`HFT` does not cover); its ``forward`` is the
    per-site forward. As in the JAX package, ``remat`` does not apply."""

    def __init__(self, config: Config, device: torch.device | str):
        m = config.model
        encoder = (CNNBlockEncoder if m.enc_alg == "cnnblock_safreq"
                   else Encoder)
        decoder = (LinearSAtimeDecoder if m.dec_alg == "linear_satime"
                   else Decoder)
        super().__init__(config, device, encoder, decoder, remat=False)

    def forward(self, spec: torch.Tensor, seeds=None) -> dict:
        return self.per_site(spec, seeds)
