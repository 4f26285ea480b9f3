"""hFT-Transformer as a plain PyTorch module.

Port of :mod:`nylon_amt_tpu.models.hft` (reference
``hftt_code/model/model_spec2midi.py``). The module tree carries the
reference's attribute names, so ``state_dict()`` keys are exactly the
reference's (``encoder_spec2midi.*``, ``decoder_spec2midi.*``, the keys of
:func:`nylon_amt_tpu_torch.train.importer.build_rules`) and reference ``.dat``
checkpoints load with ``strict=True``.

:meth:`HFT.forward` is the plain twin of the whole model: the same dict of
logits as the JAX ``HFT.apply`` (minus the attention map), with the same
rounding points in ``config.model.compute_dtype``:

* the encoder stem is the reference's unfold -> Conv2d -> Linear collapsed
  into one 65-tap convolution (:func:`stem_effective_kernel`), kept in f32;
* projections accumulate in f32 and round to the compute dtype before the
  bias add; attention scores and softmax are f32;
* post-LN residual blocks share ONE LayerNorm per layer (f32 two-pass
  statistics, eps 1e-5);
* token embeddings are scaled by sqrt(hid) before the position embedding;
  note queries are not.

Only the main architecture is covered: :func:`supports` rejects the
ablation encoders/decoders, the tablature head and the attention map.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.ops.layer_fused import (
    _layer_norm, _matmul, fused_stem, sqrt_hid)
from nylon_amt_tpu_torch.ops.precision import full_f32

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def supports(config: Config) -> bool:
    """The port covers the main architecture (``cnntime_safreq`` encoder,
    ``cafreq_satime`` or stage-1-only ``cafreq`` decoder) without the
    attention map or the tablature head."""
    m = config.model
    return (m.enc_alg == "cnntime_safreq"
            and m.dec_alg in ("cafreq_satime", "cafreq")
            and not m.return_attention and not m.tab_head
            and m.compute_dtype in DTYPES)


def stem_effective_kernel(conv_w, conv_b, emb_w, emb_b, *, cnn_channel,
                          cnn_kernel, hid_dim, n_margin):
    """Collapse unfold -> Conv2d -> Linear into one 65-tap kernel ``k_eff
    [n_proc, hid]`` and bias ``b_eff [hid]``:
    ``K_eff[m, h] = sum_{c, j, k: j + k = m} W_emb[(c, k), h] W_conv[c, j]``,
    ``b_eff[h] = b_emb[h] + sum_{c, k} W_emb[(c, k), h] b_conv[c]``.

    ``conv_w [C, k]``, ``emb_w [C * conv_out, hid]`` (Linear weight
    transposed); computed in f32.
    """
    n_proc = 2 * n_margin + 1
    conv_out = n_proc - (cnn_kernel - 1)
    with full_f32():
        w = emb_w.float().reshape(cnn_channel, conv_out, hid_dim)
        k_eff = torch.zeros((n_proc, hid_dim), dtype=torch.float32,
                            device=w.device)
        for j in range(cnn_kernel):
            shifted = F.pad(w, (0, 0, j, cnn_kernel - 1 - j))
            k_eff = k_eff + torch.einsum("c,cmh->mh", conv_w[:, j].float(),
                                         shifted)
        b_eff = emb_b.float() + torch.einsum("cph,c->h", w, conv_b.float())
    return k_eff, b_eff


def _linear(x, lin: nn.Linear, dt):
    return _matmul(x.to(dt), lin.weight.t().to(dt), lin.bias.to(dt))


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA (ref ``MultiHeadAttentionLayer:308-360``)."""

    def __init__(self, hid_dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.fc_q = nn.Linear(hid_dim, hid_dim)
        self.fc_k = nn.Linear(hid_dim, hid_dim)
        self.fc_v = nn.Linear(hid_dim, hid_dim)
        self.fc_o = nn.Linear(hid_dim, hid_dim)

    def forward(self, query, key, value, dt):
        B, lq, hid = query.shape
        d = hid // self.n_heads

        def heads(x, lin):
            return _linear(x, lin, dt).reshape(B, -1, self.n_heads, d)

        q, k, v = heads(query, self.fc_q), heads(key, self.fc_k), \
            heads(value, self.fc_v)
        energy = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = torch.softmax(energy / math.sqrt(d), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", attn.to(dt).float(), v.float())
        return _linear(o.to(dt).reshape(B, lq, hid), self.fc_o, dt)


class FeedForward(nn.Module):
    """Linear-ReLU-Linear (ref ``PositionwiseFeedforwardLayer:362-378``)."""

    def __init__(self, hid_dim: int, pf_dim: int):
        super().__init__()
        self.fc_1 = nn.Linear(hid_dim, pf_dim)
        self.fc_2 = nn.Linear(pf_dim, hid_dim)

    def forward(self, x, dt):
        return _linear(torch.relu(_linear(x, self.fc_1, dt)), self.fc_2, dt)


class _PostLNBlock(nn.Module):
    """LayerNorm + FFN shared by the three layer kinds: ONE LayerNorm
    instance is applied after every residual of the layer."""

    def __init__(self, hid_dim: int, pf_dim: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(hid_dim)
        self.positionwise_feedforward = FeedForward(hid_dim, pf_dim)

    def _ln(self, x):
        return _layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)

    def _ffn(self, x, dt):
        return self._ln(x + self.positionwise_feedforward(x, dt))


class EncoderLayer(_PostLNBlock):
    """Post-LN self-attention block (ref ``EncoderLayer:222-245``)."""

    def __init__(self, hid_dim: int, n_heads: int, pf_dim: int):
        super().__init__(hid_dim, pf_dim)
        self.self_attention = MultiHeadAttention(hid_dim, n_heads)

    def forward(self, src, dt):
        src = self._ln(src + self.self_attention(src, src, src, dt))
        return self._ffn(src, dt)


class DecoderLayerZero(_PostLNBlock):
    """Cross-attention-only decoder layer (ref ``DecoderLayer_Zero:247-272``)."""

    def __init__(self, hid_dim: int, n_heads: int, pf_dim: int):
        super().__init__(hid_dim, pf_dim)
        self.encoder_attention = MultiHeadAttention(hid_dim, n_heads)

    def forward(self, enc, trg, dt):
        trg = self._ln(trg + self.encoder_attention(trg, enc, enc, dt))
        return self._ffn(trg, dt)


class DecoderLayer(DecoderLayerZero):
    """Self + cross attention decoder layer (ref ``DecoderLayer:274-306``)."""

    def __init__(self, hid_dim: int, n_heads: int, pf_dim: int):
        super().__init__(hid_dim, n_heads, pf_dim)
        self.self_attention = MultiHeadAttention(hid_dim, n_heads)

    def forward(self, enc, trg, dt):
        trg = self._ln(trg + self.self_attention(trg, trg, trg, dt))
        return super().forward(enc, trg, dt)


class Encoder(nn.Module):
    """Frequency encoder (ref ``Encoder_SPEC2MIDI:41-106``)."""

    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        self.n_margin = config.input.margin_b
        n_proc = 2 * self.n_margin + 1
        cnn_dim = m.cnn_channel * (n_proc - (m.cnn_kernel - 1))
        self.conv = nn.Conv2d(1, m.cnn_channel, kernel_size=(1, m.cnn_kernel))
        self.tok_embedding_freq = nn.Linear(cnn_dim, m.hid_dim)
        self.pos_embedding_freq = nn.Embedding(config.feature.n_bins,
                                               m.hid_dim)
        self.layers_freq = nn.ModuleList(
            EncoderLayer(m.hid_dim, m.enc_head, m.pf_dim)
            for _ in range(m.enc_layer))

    def stem_kernel(self, config: Config):
        m = config.model
        conv_w = self.conv.weight.reshape(m.cnn_channel, m.cnn_kernel)
        return stem_effective_kernel(
            conv_w, self.conv.bias, self.tok_embedding_freq.weight.t(),
            self.tok_embedding_freq.bias, cnn_channel=m.cnn_channel,
            cnn_kernel=m.cnn_kernel, hid_dim=m.hid_dim,
            n_margin=self.n_margin)

    def forward(self, spec, config: Config, dt):
        hid = config.model.hid_dim
        k_eff, b_eff = self.stem_kernel(config)
        emb = fused_stem(spec, k_eff, b_eff, dt)
        B, n_frame, n_bin, _ = emb.shape
        h = emb.reshape(B * n_frame, n_bin, hid)
        h = h * sqrt_hid(hid, dt) + self.pos_embedding_freq.weight.to(dt)
        for layer in self.layers_freq:
            h = layer(h, dt)
        return h                                   # [B*n_frame, n_bin, hid]


class Decoder(nn.Module):
    """Two-stage decoder (ref ``Decoder_SPEC2MIDI:112-216``); stage 2 only
    for ``dec_alg == "cafreq_satime"``."""

    def __init__(self, config: Config):
        super().__init__()
        m = config.model
        hid, n_vel = m.hid_dim, config.midi.num_velocity
        self.pos_embedding_freq = nn.Embedding(config.midi.num_note, hid)
        self.layer_zero_freq = DecoderLayerZero(hid, m.dec_head, m.pf_dim)
        self.layers_freq = nn.ModuleList(
            DecoderLayer(hid, m.dec_head, m.pf_dim)
            for _ in range(m.dec_layer - 1))
        self.fc_onset_freq = nn.Linear(hid, 1)
        self.fc_offset_freq = nn.Linear(hid, 1)
        self.fc_mpe_freq = nn.Linear(hid, 1)
        self.fc_velocity_freq = nn.Linear(hid, n_vel)
        self.stage2 = m.dec_alg == "cafreq_satime"
        if self.stage2:
            self.pos_embedding_time = nn.Embedding(config.input.num_frame, hid)
            self.layers_time = nn.ModuleList(
                EncoderLayer(hid, m.dec_head, m.pf_dim)
                for _ in range(m.dec_layer))
            self.fc_onset_time = nn.Linear(hid, 1)
            self.fc_offset_time = nn.Linear(hid, 1)
            self.fc_mpe_time = nn.Linear(hid, 1)
            self.fc_velocity_time = nn.Linear(hid, n_vel)

    def forward(self, enc, B, dt):
        n, _, hid = enc.shape
        n_frame = n // B
        n_note = self.pos_embedding_freq.num_embeddings
        trg = self.pos_embedding_freq.weight.to(dt)[None].expand(
            n, n_note, hid)
        trg = self.layer_zero_freq(enc, trg, dt)
        for layer in self.layers_freq:
            trg = layer(enc, trg, dt)
        with full_f32():
            out = {
                f"{k}_A": _linear(trg, getattr(self, f"fc_{k}_freq"), dt)
                .reshape(B, n_frame, n_note, -1)
                for k in ("onset", "offset", "mpe", "velocity")}
        for k in ("onset", "offset", "mpe"):
            out[f"{k}_A"] = out[f"{k}_A"][..., 0]
        if not self.stage2:
            return out
        t = trg.reshape(B, n_frame, n_note, hid).transpose(1, 2)
        t = t.reshape(B * n_note, n_frame, hid)
        t = t * sqrt_hid(hid, dt) + self.pos_embedding_time.weight.to(dt)
        for layer in self.layers_time:
            t = layer(t, dt)
        with full_f32():
            for k in ("onset", "offset", "mpe", "velocity"):
                y = _linear(t, getattr(self, f"fc_{k}_time"), dt)
                y = y.reshape(B, n_note, n_frame, -1).transpose(1, 2)
                out[f"{k}_B"] = y[..., 0] if k != "velocity" else y
        return out


class HFT(nn.Module):
    """Full hFT model (ref ``Model_SPEC2MIDI:9-35``).

    ``forward(spec [B, n_bin, margin_b + n_frame + margin_f])`` -> dict of
    logits; apply ``torch.sigmoid`` to onset/offset/mpe for posteriors.

    The parameters are created on ``device`` UNINITIALISED (no global RNG is
    drawn): load a ``state_dict`` or call
    :func:`nylon_amt_tpu_torch.models.init.reference_initialize`.
    """

    def __init__(self, config: Config, device: torch.device | str):
        super().__init__()
        if not supports(config):
            raise ValueError(f"nylon_amt_tpu_torch does not port this "
                             f"architecture: {config.model}")
        config.validate()
        self.config = config
        with torch.device("meta"):
            self.encoder_spec2midi = Encoder(config)
            self.decoder_spec2midi = Decoder(config)
        self.to_empty(device=device)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config.model.compute_dtype]

    def forward(self, spec: torch.Tensor) -> dict[str, torch.Tensor]:
        dt = self.dtype
        enc = self.encoder_spec2midi(spec, self.config, dt)
        return self.decoder_spec2midi(enc, spec.shape[0], dt)
