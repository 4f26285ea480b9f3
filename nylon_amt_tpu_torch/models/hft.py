"""hFT-Transformer as a plain PyTorch module.

Port of :mod:`nylon_amt_tpu.models.hft` (reference
``hftt_code/model/model_spec2midi.py``). The module tree carries the
reference's attribute names, so ``state_dict()`` keys are exactly the
reference's (``encoder_spec2midi.*``, ``decoder_spec2midi.*``, the keys of
:func:`nylon_amt_tpu_torch.train.importer.build_rules`) and reference ``.dat``
checkpoints load with ``strict=True``.

Two forwards share the modules, with the same rounding points in
``config.model.compute_dtype``:

* :meth:`HFT.forward` is the plain twin of the inference engine: the JAX
  module's XLA attention branch (``attention_impl="xla"``), deterministic,
  without the attention map;
* :meth:`HFT.per_site` is the JAX module with ``attention_impl="pallas"``:
  every attention site through the per-site kernels K10 (``fused_mha``),
  K11 (``fused_mha_with_probs``, at the site whose map
  ``return_attention`` asks for) and K12 (``fused_mha_dropout``, when
  training with dropout), the activation and embedding dropout through K6
  masks, and ``remat`` as ``torch.utils.checkpoint`` around the encoder and
  the decoder. It is what the port runs where the engine or the fused
  training layers do not cover the configuration, as the JAX package does.

Numerics of both:

* the encoder stem is the reference's unfold -> Conv2d -> Linear collapsed
  into one 65-tap convolution (:func:`stem_effective_kernel`), kept in f32;
* projections accumulate in f32 and round to the compute dtype before the
  bias add; attention scores and softmax are f32;
* post-LN residual blocks share ONE LayerNorm per layer (f32 two-pass
  statistics, eps 1e-5);
* token embeddings are scaled by sqrt(hid) before the position embedding;
  note queries are not.

Dropout: the flax ``nn.Dropout`` sites draw from ``jax.random``, which
PyTorch cannot reproduce. The port masks every dropout site with the K6
hash mask of a seed per site (:func:`site_names`, drawn by
:func:`draw_site_seeds` from the trainer's ``torch.Generator``): a different
but equally random stream. K12's seed is the JAX function's, so the kernel
is held against JAX with JAX's seed.

:func:`build_model` builds :class:`HFT` for the main architecture and
:class:`~nylon_amt_tpu_torch.models.ablation.AblationModel` for the other
encoders and decoders of the ablation grid. ``config.model.tab_head``
adds the tablature head ``fc_string_time`` on the stage-2 tokens (both
forwards): ``string_B [B, n_frame, n_note, n_strings + 1]`` class logits
(0 = no string).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.ops.attention import (
    dropout,
    fused_mha,
    fused_mha_dropout,
    fused_mha_with_probs,
)
from nylon_amt_tpu_torch.ops.layer_fused import (
    _layer_norm, _matmul, fused_stem, sqrt_hid)
from nylon_amt_tpu_torch.ops.precision import full_f32

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ENCODERS = ("cnntime_safreq", "cnnblock_safreq")
DECODERS = ("cafreq_satime", "cafreq", "linear_satime")

# Mask tags of a layer's activation sites (its attention probabilities take
# their own seed): the tags of the fused training layers' sites.
_ATTN_OUT, _FFN_MID, _FFN_OUT, _SA_OUT, _EMB = 1, 2, 3, 5, 6


def ported(config: Config) -> bool:
    """:func:`build_model` builds this configuration: any encoder and
    decoder of the ablation grid (the tablature head with the main
    two-stage decoder, as ``ModelConfig.validate`` requires)."""
    m = config.model
    return (m.enc_alg in ENCODERS and m.dec_alg in DECODERS
            and m.compute_dtype in DTYPES)


def is_main(config: Config) -> bool:
    """The main architecture (:class:`HFT`): the ``cnntime_safreq`` encoder
    and the ``cafreq_satime`` or stage-1-only ``cafreq`` decoder."""
    m = config.model
    return (ported(config) and m.enc_alg == "cnntime_safreq"
            and m.dec_alg in ("cafreq_satime", "cafreq"))


def site_names(config: Config) -> list[str]:
    """The dropout seeds of a per-site training forward, by site: ``enc.i``
    (frequency layer i's activations; ``enc.0`` also the embedding),
    ``enc.i.sa`` (its attention probabilities), ``conv`` (the CNN blocks of
    ``cnnblock_safreq``), ``dec.0`` / ``dec.0.ca`` (decoder layer zero),
    ``dec.i`` / ``dec.i.sa`` / ``dec.i.ca``, ``time.i`` / ``time.i.sa``
    (stage 2; ``time.0`` also its embedding)."""
    m = config.model
    names = [n for i in range(m.enc_layer) for n in (f"enc.{i}",
                                                     f"enc.{i}.sa")]
    if m.enc_alg == "cnnblock_safreq":
        names.append("conv")
    if m.dec_alg != "linear_satime":
        names += ["dec.0", "dec.0.ca"]
        names += [f"dec.{i}{s}" for i in range(1, m.dec_layer)
                  for s in ("", ".sa", ".ca")]
    if m.dec_alg != "cafreq":
        names += [n for i in range(m.dec_layer) for n in (f"time.{i}",
                                                          f"time.{i}.sa")]
    return names


def draw_site_seeds(config: Config, generator: torch.Generator
                    ) -> dict[str, int]:
    """One seed in ``[0, 2**31 - 1)`` per :func:`site_names` entry."""
    names = site_names(config)
    draw = torch.randint(0, 2 ** 31 - 1, (len(names),), generator=generator)
    return dict(zip(names, (int(s) for s in draw)))


class Sites:
    """How the modules run. ``per_site`` False: the engine's plain twin
    (the XLA attention branch, deterministic). True: the per-site kernels;
    with ``seeds`` (one per :func:`site_names` entry) the forward trains
    (dropout at ``rate``, BatchNorm on batch statistics), without them it is
    deterministic (JAX's ``deterministic=True``)."""

    def __init__(self, per_site: bool, seeds: Mapping[str, int] | None = None,
                 rate: float = 0.0):
        self.per_site = per_site
        self.seeds = seeds
        self.rate = rate

    @property
    def train(self) -> bool:
        return self.seeds is not None

    def active(self, rate: float | None = None) -> bool:
        return self.train and (self.rate if rate is None else rate) > 0.0

    def drop(self, x, name: str, tag: int, rate: float | None = None):
        """``x`` through dropout site ``(name, tag)`` when it is active."""
        rate = self.rate if rate is None else rate
        if not self.active(rate):
            return x
        return dropout(x, self.seeds[name], tag, rate)


PLAIN = Sites(per_site=False)


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

    def forward(self, query, key, value, dt, sites: Sites, name: str,
                need_weights: bool = False):
        """``(out, attention map [B, H, Lq, Lk] or None)``. Per site: K11
        where the map is needed, K12 under dropout, K10 otherwise; where the
        map is needed under dropout, the XLA branch, as JAX routes it
        (``models/hft.py:173-174``)."""
        if not sites.per_site or (need_weights and sites.active()):
            out, attn = self._xla(query, key, value, dt,
                                  lambda a: sites.drop(a, name, 0))
            return out, attn if need_weights else None
        q, k, v = (_linear(x, lin, dt) for x, lin in
                   ((query, self.fc_q), (key, self.fc_k), (value, self.fc_v)))
        h = self.n_heads
        scale = 1.0 / float(q.shape[-1] // h) ** 0.5
        attn = None
        if need_weights:
            o, attn = fused_mha_with_probs(q, k, v, h, scale)
        elif sites.active():
            o = fused_mha_dropout(q, k, v, h, scale, sites.rate,
                                  sites.seeds[name])
        else:
            o = fused_mha(q, k, v, h, scale)
        return _linear(o, self.fc_o, dt), attn

    def _xla(self, query, key, value, dt, drop):
        B, lq, hid = query.shape
        d = hid // self.n_heads

        def heads(x, lin):
            return _linear(x, lin, dt).reshape(B, -1, self.n_heads, d)

        q, k, v = heads(query, self.fc_q), heads(key, self.fc_k), \
            heads(value, self.fc_v)
        energy = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = torch.softmax(energy / math.sqrt(d), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", drop(attn).to(dt).float(),
                         v.float())
        return _linear(o.to(dt).reshape(B, lq, hid), self.fc_o, dt), attn


class FeedForward(nn.Module):
    """Linear-ReLU-dropout-Linear (ref
    ``PositionwiseFeedforwardLayer:362-378``)."""

    def __init__(self, hid_dim: int, pf_dim: int):
        super().__init__()
        self.fc_1 = nn.Linear(hid_dim, pf_dim)
        self.fc_2 = nn.Linear(pf_dim, hid_dim)

    def forward(self, x, dt, sites: Sites, name: str):
        mid = sites.drop(torch.relu(_linear(x, self.fc_1, dt)), name, _FFN_MID)
        return _linear(mid, self.fc_2, dt)


class _PostLNBlock(nn.Module):
    """LayerNorm + FFN shared by the three layer kinds: ONE LayerNorm
    instance is applied after every residual of the layer. ``site`` names
    the layer's dropout seeds (:func:`site_names`)."""

    def __init__(self, hid_dim: int, pf_dim: int, site: str):
        super().__init__()
        self.site = site
        self.layer_norm = nn.LayerNorm(hid_dim)
        self.positionwise_feedforward = FeedForward(hid_dim, pf_dim)

    def _ln(self, x):
        return _layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)

    def _residual(self, x, y, sites: Sites, tag: int):
        return self._ln(x + sites.drop(y, self.site, tag))

    def _ffn(self, x, dt, sites: Sites):
        ff = self.positionwise_feedforward(x, dt, sites, self.site)
        return self._residual(x, ff, sites, _FFN_OUT)


class EncoderLayer(_PostLNBlock):
    """Post-LN self-attention block (ref ``EncoderLayer:222-245``)."""

    def __init__(self, hid_dim: int, n_heads: int, pf_dim: int, site: str):
        super().__init__(hid_dim, pf_dim, site)
        self.self_attention = MultiHeadAttention(hid_dim, n_heads)

    def forward(self, src, dt, sites: Sites):
        a, _ = self.self_attention(src, src, src, dt, sites,
                                   f"{self.site}.sa")
        return self._ffn(self._residual(src, a, sites, _ATTN_OUT), dt, sites)


class DecoderLayerZero(_PostLNBlock):
    """Cross-attention-only decoder layer (ref ``DecoderLayer_Zero:247-272``);
    returns ``(trg, attention map or None)``."""

    def __init__(self, hid_dim: int, n_heads: int, pf_dim: int, site: str):
        super().__init__(hid_dim, pf_dim, site)
        self.encoder_attention = MultiHeadAttention(hid_dim, n_heads)

    def forward(self, enc, trg, dt, sites: Sites, need_weights=False):
        a, attn = self.encoder_attention(trg, enc, enc, dt, sites,
                                         f"{self.site}.ca", need_weights)
        return self._ffn(self._residual(trg, a, sites, _ATTN_OUT), dt,
                         sites), attn


class DecoderLayer(DecoderLayerZero):
    """Self + cross attention decoder layer (ref ``DecoderLayer:274-306``)."""

    def __init__(self, hid_dim: int, n_heads: int, pf_dim: int, site: str):
        super().__init__(hid_dim, n_heads, pf_dim, site)
        self.self_attention = MultiHeadAttention(hid_dim, n_heads)

    def forward(self, enc, trg, dt, sites: Sites, need_weights=False):
        a, _ = self.self_attention(trg, trg, trg, dt, sites,
                                   f"{self.site}.sa")
        trg = self._residual(trg, a, sites, _SA_OUT)
        return super().forward(enc, trg, dt, sites, need_weights)


def _embed(emb, pos, hid, dt, sites: Sites, site: str):
    """``emb * sqrt(hid) + pos``, then the embedding dropout site."""
    return sites.drop(emb * sqrt_hid(hid, dt) + pos.to(dt), site, _EMB)


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
            EncoderLayer(m.hid_dim, m.enc_head, m.pf_dim, f"enc.{i}")
            for i in range(m.enc_layer))

    def stem_kernel(self, config: Config):
        m = config.model
        conv_w = self.conv.weight.reshape(m.cnn_channel, m.cnn_kernel)
        return stem_effective_kernel(
            conv_w, self.conv.bias, self.tok_embedding_freq.weight.t(),
            self.tok_embedding_freq.bias, cnn_channel=m.cnn_channel,
            cnn_kernel=m.cnn_kernel, hid_dim=m.hid_dim,
            n_margin=self.n_margin)

    def forward(self, spec, config: Config, dt, sites: Sites):
        hid = config.model.hid_dim
        k_eff, b_eff = self.stem_kernel(config)
        emb = fused_stem(spec, k_eff, b_eff, dt)
        B, n_frame, n_bin, _ = emb.shape
        h = _embed(emb.reshape(B * n_frame, n_bin, hid),
                   self.pos_embedding_freq.weight, hid, dt, sites, "enc.0")
        for layer in self.layers_freq:
            h = layer(h, dt, sites)
        return h                                   # [B*n_frame, n_bin, hid]


def stage1_heads(dec: nn.Module, trg, B: int, n_frame: int, dt) -> dict:
    """The A heads (``fc_*_freq``) on the stage-1 tokens ``[B*n_frame,
    n_note, hid]``."""
    n_note = trg.shape[1]
    with full_f32():
        out = {f"{k}_A": _linear(trg, getattr(dec, f"fc_{k}_freq"), dt)
               .reshape(B, n_frame, n_note, -1)
               for k in ("onset", "offset", "mpe", "velocity")}
    for k in ("onset", "offset", "mpe"):
        out[f"{k}_A"] = out[f"{k}_A"][..., 0]
    return out


# the heads whose logits keep their class axis
CLASS_HEADS = ("velocity", "string")


def time_heads(dec: nn.Module) -> tuple[str, ...]:
    """The B heads ``fc_<k>_time`` of a two-stage decoder, in order; the
    tablature head ``string`` last, where the decoder has it."""
    heads = ("onset", "offset", "mpe", "velocity")
    return heads + ("string",) if hasattr(dec, "fc_string_time") else heads


def stage2(dec: nn.Module, trg, B: int, n_frame: int, dt, sites: Sites,
           out: dict) -> dict:
    """SAtime (ref ``:185-214``): the stage-1 tokens transposed to [note,
    time], the time position embedding, ``dec.layers_time``, the B heads
    (``fc_*_time``, and the tablature head ``fc_string_time`` where the
    decoder has one) added to ``out``."""
    n, n_note, hid = trg.shape
    t = trg.reshape(B, n_frame, n_note, hid).transpose(1, 2)
    t = _embed(t.reshape(B * n_note, n_frame, hid),
               dec.pos_embedding_time.weight, hid, dt, sites, "time.0")
    for layer in dec.layers_time:
        t = layer(t, dt, sites)
    with full_f32():
        for k in time_heads(dec):
            y = _linear(t, getattr(dec, f"fc_{k}_time"), dt)
            y = y.reshape(B, n_note, n_frame, -1).transpose(1, 2)
            out[f"{k}_B"] = y if k in CLASS_HEADS else y[..., 0]
    return out


class Decoder(nn.Module):
    """Two-stage decoder (ref ``Decoder_SPEC2MIDI:112-216``); stage 2 only
    for ``dec_alg == "cafreq_satime"``. With ``return_attention`` (the
    per-site forward of :class:`HFT`) the last stage-1 layer's cross
    attention map comes back as ``attention [B, n_frame, H, n_note,
    n_bin]`` (ref ``:164-165``)."""

    def __init__(self, config: Config, return_attention: bool = False):
        super().__init__()
        m = config.model
        hid, n_vel = m.hid_dim, config.midi.num_velocity
        self.return_attention = return_attention
        self.pos_embedding_freq = nn.Embedding(config.midi.num_note, hid)
        self.layer_zero_freq = DecoderLayerZero(hid, m.dec_head, m.pf_dim,
                                                "dec.0")
        self.layers_freq = nn.ModuleList(
            DecoderLayer(hid, m.dec_head, m.pf_dim, f"dec.{i}")
            for i in range(1, m.dec_layer))
        self.fc_onset_freq = nn.Linear(hid, 1)
        self.fc_offset_freq = nn.Linear(hid, 1)
        self.fc_mpe_freq = nn.Linear(hid, 1)
        self.fc_velocity_freq = nn.Linear(hid, n_vel)
        self.stage2 = m.dec_alg == "cafreq_satime"
        if self.stage2:
            self.pos_embedding_time = nn.Embedding(config.input.num_frame, hid)
            self.layers_time = nn.ModuleList(
                EncoderLayer(hid, m.dec_head, m.pf_dim, f"time.{i}")
                for i in range(m.dec_layer))
            self.fc_onset_time = nn.Linear(hid, 1)
            self.fc_offset_time = nn.Linear(hid, 1)
            self.fc_mpe_time = nn.Linear(hid, 1)
            self.fc_velocity_time = nn.Linear(hid, n_vel)
            if m.tab_head:        # string class logits, 0 = no string
                self.fc_string_time = nn.Linear(hid, m.n_strings + 1)

    def forward(self, enc, B, dt, sites: Sites):
        n, n_bin, hid = enc.shape
        n_frame = n // B
        n_note = self.pos_embedding_freq.num_embeddings
        want = self.return_attention and sites.per_site
        last = len(self.layers_freq)
        trg = self.pos_embedding_freq.weight.to(dt)[None].expand(
            n, n_note, hid)
        trg, attn = self.layer_zero_freq(enc, trg, dt, sites,
                                         want and last == 0)
        for i, layer in enumerate(self.layers_freq):
            trg, attn = layer(enc, trg, dt, sites, want and i == last - 1)
        out = stage1_heads(self, trg, B, n_frame, dt)
        if attn is not None:
            out["attention"] = attn.reshape(B, n_frame, -1, n_note, n_bin)
        if self.stage2:
            stage2(self, trg, B, n_frame, dt, sites, out)
        return out


class Model(nn.Module):
    """An encoder and a decoder built on ``device`` UNINITIALISED (no
    global RNG is drawn): load a ``state_dict`` or call
    :func:`nylon_amt_tpu_torch.models.init.reference_initialize`."""

    def __init__(self, config: Config, device, encoder, decoder,
                 remat: bool):
        super().__init__()
        if not ported(config):
            raise ValueError(f"nylon_amt_tpu_torch does not port this "
                             f"architecture: {config.model}")
        config.validate()
        self.config = config
        self.remat = remat
        with torch.device("meta"):
            self.encoder_spec2midi = encoder(config)
            self.decoder_spec2midi = decoder(config)
        self.to_empty(device=device)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config.model.compute_dtype]

    def per_site(self, spec: torch.Tensor,
                 seeds: Mapping[str, int] | None = None) -> dict:
        """The per-site forward: ``spec [B, n_bin, margin_b + n_frame +
        margin_f]`` -> dict of logits (and ``attention`` when the config
        returns it). ``seeds`` (:func:`draw_site_seeds`) trains: dropout at
        ``config.model.dropout``, BatchNorm on batch statistics (and its
        running statistics updated). With ``self.remat``, while gradients
        are recorded, the encoder and the decoder run under
        ``torch.utils.checkpoint``: the backward recomputes them, and the
        seeds (drawn before) give the same masks."""
        return self._run(spec, Sites(True, seeds, self.config.model.dropout))

    def _run(self, spec, sites: Sites) -> dict:
        dt, B = self.dtype, spec.shape[0]

        def enc(s):
            return self.encoder_spec2midi(s, self.config, dt, sites)

        def dec(h):
            return self.decoder_spec2midi(h, B, dt, sites)

        if sites.per_site and self.remat and torch.is_grad_enabled():
            return checkpoint(dec, checkpoint(enc, spec, use_reentrant=False),
                              use_reentrant=False)
        return dec(enc(spec))


class HFT(Model):
    """Full hFT model (ref ``Model_SPEC2MIDI:9-35``), the main architecture.

    ``forward(spec [B, n_bin, margin_b + n_frame + margin_f])`` -> dict of
    logits, the engine's plain twin; :meth:`per_site` is the per-site path.
    Apply ``torch.sigmoid`` to onset/offset/mpe for posteriors.
    """

    def __init__(self, config: Config, device: torch.device | str):
        if not is_main(config):
            raise ValueError(f"HFT is the main architecture; build_model "
                             f"builds the others: {config.model}")
        super().__init__(config, device, Encoder, lambda cfg: Decoder(
            cfg, return_attention=cfg.model.return_attention),
            remat=config.model.remat)

    def forward(self, spec: torch.Tensor) -> dict[str, torch.Tensor]:
        return self._run(spec, PLAIN)


def build_model(config: Config, device: torch.device | str) -> Model:
    """:class:`HFT` for the main architecture, the ablation model of
    ``config.model.enc_alg`` / ``dec_alg`` otherwise (JAX's
    ``build_model``)."""
    if is_main(config):
        return HFT(config, device)
    from nylon_amt_tpu_torch.models.ablation import AblationModel

    return AblationModel(config, device)
