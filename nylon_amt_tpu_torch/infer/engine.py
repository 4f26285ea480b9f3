"""Inference engine for the hFT model on the port's layer kernels.

Port of :mod:`nylon_amt_tpu.infer.engine`. ``forward(packed, spec, config)``
reproduces the deterministic ``HFT.forward`` logits through the layer
wrappers of :mod:`nylon_amt_tpu_torch.ops.layer_fused`: K2
(``encoder_layer_with_stem``) for the stem and the first frequency-encoder
layer, K3 (``encoder_layer``) for the other frequency-encoder layers and
every stage-2 time layer, K4
(``decoder_layer_zero``) and K5 (``decoder_layer``) for the stage-1 decoder.
With ``precision="int8"`` the same five places take the W8A8 twins of K13
(:mod:`nylon_amt_tpu_torch.ops.layer_fused_q8`): per-channel int8 weights,
quantized once at pack time from the compute-dtype weights, and dynamic
per-row int8 activations; the stem, the output heads, LayerNorm and softmax
keep the exact path's numerics. The int8 layers hand each other their
outputs' row codes (``codes_out``, then ``x_codes`` / ``trg_codes`` /
``enc_codes``), so only the first layer of each stream (the stem layer,
the decoder's layer zero on the note queries, the first time layer)
quantizes its input itself. On CUDA tensors every layer launches its
kernels, in the compute dtype of the pack (bfloat16, or float32 as the
default configuration); on CPU tensors the same code runs the plain
versions.

The 65-tap stem, the sqrt(hid) scale and the frequency position embedding
run in K2 (``encoder_layer_with_stem``) with the first frequency layer, as
in the JAX engine; the output heads are plain matmuls, as the JAX engine
leaves them to XLA.

Weights are packed once, by :func:`pack_params`, when a transcriber is
built: under ``jit`` the JAX engine packs at trace time for free, eagerly it
would cost a repack per forward. A float32 pack on the card also holds each
layer matrix's TF32 pair (``layer_fused.pack_tf32``), the form the float32
GEMM kernels read; an int8 pack on the card each layer matrix's codes
K-major, ``W^T [N, K]`` (``layer_fused_q8.pack_wt``), the form the s8 GEMM
kernels read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.models.hft import HFT, is_main
from nylon_amt_tpu_torch.ops.layer_fused import (
    CrossLayerParams,
    EncoderLayerParams,
    _matmul,
    decoder_layer,
    decoder_layer_zero,
    encoder_layer,
    encoder_layer_with_stem,
    pack_tf32,
    sqrt_hid,
)
from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
from nylon_amt_tpu_torch.ops.precision import full_f32

__all__ = ["PackedHFT", "forward", "pack_params", "supports"]

_KEYS = ("onset", "offset", "mpe", "velocity")


def supports(config: Config) -> bool:
    """The engine covers the main architecture without the attention map
    (JAX's ``engine.supports``); the other configurations run the module's
    per-site forward (:meth:`HFT.per_site`)."""
    return is_main(config) and not config.model.return_attention


class PackedHFT(NamedTuple):
    """The model's weights in the engine's layout and compute dtype; with
    ``precision`` "int8", every layer's weights quantized
    (``Q8EncoderLayerParams`` / ``Q8CrossLayerParams``)."""

    dtype: torch.dtype
    k_eff: torch.Tensor                  # [n_proc, hid] f32 stem
    b_eff: torch.Tensor                  # [hid] f32
    pos_freq: torch.Tensor               # [n_bin, hid]
    enc: list[EncoderLayerParams]
    note_q: torch.Tensor                 # [n_note, hid]
    dec_zero: CrossLayerParams
    dec: list[CrossLayerParams]
    heads_a: dict[str, tuple[torch.Tensor, torch.Tensor]]
    pos_time: torch.Tensor | None        # [n_frame, hid]; None for cafreq
    time: list[EncoderLayerParams]
    heads_b: dict[str, tuple[torch.Tensor, torch.Tensor]]
    precision: str | None = None
    # float32 on the card: the TF32 pairs of each layer's matrices, by group
    # ("enc", "dec_zero", "dec", "time") and layer (layer_fused.pack_tf32)
    tf32: dict | None = None
    # int8 on the card: each layer's codes as W^T [N, K], by group and layer
    # (layer_fused_q8.pack_wt)
    wt: dict | None = None


def _lin(lin, dt, *more):
    """Linear weight(s) as ``[in, out]`` (concatenated along out) + bias."""
    lins = (lin, *more)
    w = torch.cat([m.weight.t() for m in lins], dim=1)
    b = torch.cat([m.bias for m in lins])
    return w.to(dt).contiguous(), b.to(dt).contiguous()


def _ln_ffn(layer, dt) -> dict:
    ln, ff = layer.layer_norm, layer.positionwise_feedforward
    w1, b1 = _lin(ff.fc_1, dt)
    w2, b2 = _lin(ff.fc_2, dt)
    return dict(g=ln.weight.float().contiguous(),
                b=ln.bias.float().contiguous(), w1=w1, b1=b1, w2=w2, b2=b2)


def _pack_encoder(layer, dt) -> EncoderLayerParams:
    sa = layer.self_attention
    wqkv, bqkv = _lin(sa.fc_q, dt, sa.fc_k, sa.fc_v)
    wo, bo = _lin(sa.fc_o, dt)
    return EncoderLayerParams(wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo,
                              **_ln_ffn(layer, dt))


def _pack_cross(layer, dt) -> CrossLayerParams:
    ca = layer.encoder_attention
    wq, bq = _lin(ca.fc_q, dt)
    wkv, bkv = _lin(ca.fc_k, dt, ca.fc_v)
    wo, bo = _lin(ca.fc_o, dt)
    hid = wq.shape[0]
    if hasattr(layer, "self_attention"):
        sa = layer.self_attention
        wsqkv, bsqkv = _lin(sa.fc_q, dt, sa.fc_k, sa.fc_v)
        wso, bso = _lin(sa.fc_o, dt)
    else:                                  # layer zero: no self-attention
        wsqkv = torch.zeros((hid, 0), dtype=dt, device=wq.device)
        bsqkv = torch.zeros((0,), dtype=dt, device=wq.device)
        wso = torch.zeros((hid, hid), dtype=dt, device=wq.device)
        bso = torch.zeros((hid,), dtype=dt, device=wq.device)
    return CrossLayerParams(wsqkv=wsqkv, bsqkv=bsqkv, wso=wso, bso=bso,
                            wq=wq, bq=bq, wkv=wkv, bkv=bkv, wo=wo, bo=bo,
                            **_ln_ffn(layer, dt))


@torch.no_grad()
def pack_params(model: HFT, dtype: torch.dtype,
                precision: str | None = None) -> PackedHFT:
    """Pack ``model``'s weights once, on the model's device. Only
    ``precision="int8"`` changes the path: the layer weights are then
    quantized here, once, after the cast to ``dtype`` (as the JAX engine
    packs with ``.astype(dt)`` first: quantizing the f32 master weights
    would give other codes and scales)."""
    q8 = precision == "int8"

    def enc_pack(layer):
        p = _pack_encoder(layer, dtype)
        return lq.quantize_encoder_params(p) if q8 else p

    def cross_pack(layer):
        p = _pack_cross(layer, dtype)
        return lq.quantize_cross_params(p) if q8 else p

    enc, dec = model.encoder_spec2midi, model.decoder_spec2midi
    k_eff, b_eff = enc.stem_kernel(model.config)
    heads = {s: {k: _lin(getattr(dec, f"fc_{k}_{t}"), dtype) for k in _KEYS}
             for s, t in (("a", "freq"), ("b", "time"))
             if s == "a" or dec.stage2}
    layers = dict(
        enc=[enc_pack(layer) for layer in enc.layers_freq],
        dec_zero=cross_pack(dec.layer_zero_freq),
        dec=[cross_pack(layer) for layer in dec.layers_freq],
        time=[enc_pack(layer) for layer in dec.layers_time]
        if dec.stage2 else [])
    packs = {}  # the kernels' forms of the weights, made on the card only
    if (enc.pos_embedding_freq.weight.device.type == "cuda"
            and (q8 or dtype == torch.float32)):
        pack = lq.pack_wt if q8 else pack_tf32
        packs["wt" if q8 else "tf32"] = {
            group: [pack(p) for p in ps] if isinstance(ps, list) else pack(ps)
            for group, ps in layers.items()}
    return PackedHFT(
        dtype=dtype, k_eff=k_eff, b_eff=b_eff,
        pos_freq=enc.pos_embedding_freq.weight.to(dtype),
        note_q=dec.pos_embedding_freq.weight.to(dtype),
        heads_a=heads["a"],
        pos_time=dec.pos_embedding_time.weight.to(dtype) if dec.stage2
        else None,
        heads_b=heads.get("b", {}), precision="int8" if q8 else None,
        **packs, **layers)


def _dense(x, head):
    with full_f32():
        return _matmul(x, *head)


@torch.no_grad()
def forward(packed: PackedHFT, spec: torch.Tensor, config: Config) -> dict:
    """``spec [B, n_bin, margin_b + n_frame + margin_f]`` -> dict of logits
    with the keys and shapes of ``HFT.forward``."""
    m = config.model
    dt = packed.dtype
    B = spec.shape[0]
    n_frame = config.input.num_frame
    n_note, hid = config.midi.num_note, m.hid_dim
    scale = sqrt_hid(hid, dt)
    q8 = packed.precision == "int8"
    if q8:
        stem_layer, enc_layer = lq.encoder_layer_with_stem_q8, \
            lq.encoder_layer_q8
        dec_zero, dec_layer = lq.decoder_layer_zero_q8, lq.decoder_layer_q8
    else:
        stem_layer, enc_layer = encoder_layer_with_stem, encoder_layer
        dec_zero, dec_layer = decoder_layer_zero, decoder_layer

    def codes(out_codes: bool, **inputs):
        """An int8 layer call's codes keywords: its inputs' row codes
        (``x_codes`` ...) and ``codes_out``. Each int8 layer hands the next
        its output's codes, made in its last kernel's epilogue, so only the
        first layer of each stream quantizes its input; the exact layers
        take none."""
        return dict(inputs, codes_out=out_codes) if q8 else {}

    def split(out, out_codes: bool):
        """(a layer's output, its codes or None)."""
        return (out[0], out[1:]) if q8 and out_codes else (out, None)

    def pack(group, i=None):
        """The layer call's packed weights: ``tf32=`` (its TF32 pairs) or
        ``wt=`` (its int8 codes K-major), where the pack holds them."""
        for key in ("tf32", "wt"):
            packs = getattr(packed, key)
            if packs is not None:
                return {key: packs[group] if i is None else packs[group][i]}
        return {}

    # ---- frequency encoder: K2 (stem + first layer), then K3 per layer ------
    spec_t = spec.float().transpose(1, 2).contiguous()      # frame-major
    h, hc = split(stem_layer(spec_t, packed.k_eff, packed.b_eff,
                             packed.pos_freq, packed.enc[0], m.enc_head,
                             n_frame, dt, **pack("enc", 0),
                             **codes(True)), True)
    for i, p in enumerate(packed.enc[1:], 1):
        h, hc = split(enc_layer(h, p, m.enc_head, **pack("enc", i),
                                **codes(True, x_codes=hc)), True)
    enc, enc_codes = h, hc                         # [B*n_frame, n_bin, hid]

    # ---- stage 1: CAfreq, K4 then K5 per further layer ---------------------
    trg = packed.note_q.expand(B * n_frame, n_note, hid).contiguous()
    more = bool(packed.dec)
    trg, tc = split(dec_zero(trg, enc, packed.dec_zero, m.dec_head,
                             **pack("dec_zero"),
                             **codes(more, enc_codes=enc_codes)), more)
    for i, p in enumerate(packed.dec):
        more = i + 1 < len(packed.dec)
        trg, tc = split(dec_layer(trg, enc, p, m.dec_head, **pack("dec", i),
                                  **codes(more, trg_codes=tc,
                                          enc_codes=enc_codes)), more)
    out = {f"{k}_A": _dense(trg, packed.heads_a[k])
           .reshape(B, n_frame, n_note, -1) for k in _KEYS}
    if packed.pos_time is None:                    # stage-1-only decoder
        return _squeeze(out)

    # ---- stage 2: SAtime, K3 per layer --------------------------------------
    t = trg.reshape(B, n_frame, n_note, hid).transpose(1, 2)
    # (contiguous: at B = 1 the reshape is a view of the transpose)
    t = (t.reshape(B * n_note, n_frame, hid) * scale
         + packed.pos_time).contiguous()
    tc = None
    for i, p in enumerate(packed.time):
        more = i + 1 < len(packed.time)
        t, tc = split(enc_layer(t, p, m.dec_head, **pack("time", i),
                                **codes(more, x_codes=tc)), more)
    for k in _KEYS:
        out[f"{k}_B"] = (_dense(t, packed.heads_b[k])
                         .reshape(B, n_note, n_frame, -1).transpose(1, 2))
    return _squeeze(out)


def _squeeze(out: dict) -> dict:
    """Drop the unit class axis of the onset/offset/mpe heads."""
    return {k: v if k.startswith("velocity") else v[..., 0]
            for k, v in out.items()}
