"""Training forward of the hFT model over the training layer kernels.

Port of :mod:`nylon_amt_tpu.models.fused_train`: the same model, the
port's :class:`~nylon_amt_tpu_torch.models.hft.HFT` module, run through the
autograd Functions of :mod:`nylon_amt_tpu_torch.ops.layer_fused_train` (K7
for every frequency-encoder and stage-2 time layer, K8 for the first
decoder layer, K9 for the others; K6 masks inside all of them) instead of
the module's own forward. Gradients reach the module's float32 parameters
through the layers' analytic backward.

The 65-tap stem (``fused_stem``), the sqrt(hid) scale and the position
embeddings, the broadcast of the note queries and the output heads stay
PyTorch ops, as the JAX package leaves them to XLA.

Dropout seeds: JAX derives one int32 seed per layer from its dropout key
by threefry (``fold_in(key, 1000 + i)``). The port takes the seeds as an
argument, a mapping from the same slot numbers ``i`` (:func:`seed_slots`:
``0..`` frequency encoder, ``10`` decoder layer zero, ``11..`` decoder,
``20..`` time layers) to ints in ``[0, 2**31 - 1)``. The trainer draws them
from a ``torch.Generator`` (:func:`draw_seeds`): a different but equally
random stream than JAX's; the tests pass JAX's seeds in.
"""

from __future__ import annotations

from typing import Mapping

import torch

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.models.hft import DTYPES, HFT
from nylon_amt_tpu_torch.ops.layer_fused import (
    EncoderLayerParams,
    fused_stem,
    sqrt_hid,
)
from nylon_amt_tpu_torch.ops.layer_fused_train import (
    DecLayerParams,
    DecZeroParams,
    decoder_layer_train,
    decoder_layer_zero_train,
    encoder_layer_train,
)

_KEYS = ("onset", "offset", "mpe", "velocity")


def supports(config: Config) -> bool:
    """The main architecture without the attention map (as
    :func:`engine.supports`) and without rematerialisation (JAX's
    ``fused_train.supports``); the trainer runs the module's per-site
    forward otherwise."""
    return engine.supports(config) and not config.model.remat


def seed_slots(config: Config) -> list[int]:
    """The layer slots that take a dropout seed, in the JAX numbering."""
    m = config.model
    slots = list(range(m.enc_layer)) + [10]
    slots += [11 + i for i in range(m.dec_layer - 1)]
    if m.dec_alg == "cafreq_satime":
        slots += [20 + i for i in range(m.dec_layer)]
    return slots


def draw_seeds(config: Config, generator: torch.Generator) -> dict[int, int]:
    """One seed in ``[0, 2**31 - 1)`` per slot, from ``generator``."""
    slots = seed_slots(config)
    draw = torch.randint(0, 2 ** 31 - 1, (len(slots),), generator=generator)
    return dict(zip(slots, (int(s) for s in draw)))


def _pack_enc(layer) -> EncoderLayerParams:
    """The layer's float32 weights in the kernels' packing (differentiable:
    gradients reach the module's parameters)."""
    return engine._pack_encoder(layer, torch.float32)


def _pack_dec(layer, with_self: bool):
    p = engine._pack_cross(layer, torch.float32)
    cls = DecLayerParams if with_self else DecZeroParams
    return cls(**{f: getattr(p, f) for f in cls._fields})


def _dense(x, lin, dt):
    return engine._dense(x, engine._lin(lin, dt))


def train_forward(model: HFT, spec: torch.Tensor, seeds: Mapping[int, int],
                  rate: float | None = None) -> dict:
    """Training forward: the logits dict of ``HFT.forward``.

    ``spec [B, n_bin, margin_b + n_frame + margin_f]`` (float32, on the
    model's device), ``seeds`` one dropout seed per :func:`seed_slots`
    entry, ``rate`` the dropout rate (default ``config.model.dropout``; 0
    runs without masks). Embedding dropout rides in the first layer of each
    stage (``emb_drop``)."""
    cfg = model.config
    m = cfg.model
    dt = DTYPES[m.compute_dtype]
    rate = m.dropout if rate is None else rate
    enc, dec = model.encoder_spec2midi, model.decoder_spec2midi
    B = spec.shape[0]
    n_frame, n_bin = cfg.input.num_frame, cfg.feature.n_bins
    n_note, hid = cfg.midi.num_note, m.hid_dim
    scale = sqrt_hid(hid, dt).to(spec.device)

    # ---- frequency encoder ----
    k_eff, b_eff = enc.stem_kernel(cfg)
    emb = fused_stem(spec, k_eff, b_eff, dt)
    h = emb.reshape(B * n_frame, n_bin, hid) * scale \
        + enc.pos_embedding_freq.weight.to(dt)
    for i, layer in enumerate(enc.layers_freq):
        h = encoder_layer_train(h, _pack_enc(layer), seeds[i], m.enc_head,
                                rate, emb_drop=i == 0, stem=i == 0)

    # ---- stage 1: CAfreq ----
    note_q = dec.pos_embedding_freq.weight.to(dt)
    trg = note_q[None].expand(B * n_frame, n_note, hid)
    trg = decoder_layer_zero_train(trg, h, _pack_dec(dec.layer_zero_freq,
                                                     False),
                                   seeds[10], m.dec_head, rate)
    for i, layer in enumerate(dec.layers_freq):
        trg = decoder_layer_train(trg, h, _pack_dec(layer, True),
                                  seeds[11 + i], m.dec_head, rate)
    out = {f"{k}_A": _dense(trg, getattr(dec, f"fc_{k}_freq"), dt)
           .reshape(B, n_frame, n_note, -1) for k in _KEYS}
    if m.dec_alg == "cafreq":
        return engine._squeeze(out)

    # ---- stage 2: SAtime ----
    t = trg.reshape(B, n_frame, n_note, hid).transpose(1, 2)
    t = t.reshape(B * n_note, n_frame, hid) * scale \
        + dec.pos_embedding_time.weight.to(dt)
    for i, layer in enumerate(dec.layers_time):
        t = encoder_layer_train(t, _pack_enc(layer), seeds[20 + i],
                                m.dec_head, rate, emb_drop=i == 0)
    for k in _KEYS:
        out[f"{k}_B"] = (_dense(t, getattr(dec, f"fc_{k}_time"), dt)
                         .reshape(B, n_note, n_frame, -1).transpose(1, 2))
    return engine._squeeze(out)


def make_fused_apply(config: Config):
    """``apply(model, spec, seeds=None)``: :func:`train_forward` with
    dropout when ``seeds`` is given, at rate 0 when it is None (the JAX
    function's ``deterministic=True``)."""
    if not supports(config):
        raise ValueError(f"the fused training path does not cover this "
                         f"architecture: {config.model}")

    def apply(model: HFT, spec: torch.Tensor,
              seeds: Mapping[int, int] | None = None) -> dict:
        if seeds is None:
            return train_forward(model, spec,
                                 dict.fromkeys(seed_slots(config), 0), 0.0)
        return train_forward(model, spec, seeds)

    return apply
