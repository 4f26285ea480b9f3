"""Transformer layers of the inference engine (K2, K3, K4, K5) and their
plain versions.

Port of :mod:`nylon_amt_tpu.ops.layer_fused`, with the same signatures on
``[n, L, hid]`` tensors and the same weight packing:

* :func:`encoder_layer_with_stem` (K2): the 65-tap encoder stem, its bias,
  the sqrt(hid) scale and the frequency position embedding (one kernel of
  ``csrc/stem_embed.cu``), then K3's kernels for the first frequency layer;
* :func:`encoder_layer` (K3): post-LN self-attention block, used by the
  frequency encoder (L = 256 bins) and the stage-2 time layers (L = 128);
* :func:`decoder_layer_zero` (K4): cross-attention-only block, 88 note
  queries attending to the 256-bin encoder stream;
* :func:`decoder_layer` (K5): self-attention over the queries, then K4's
  tail.

One LayerNorm (g, b) is shared by every residual of a layer, as in the
reference. A CPU tensor takes the plain version; any other device launches
the hand-written kernels of ``csrc/layer_fused.cu`` (a bf16 GEMM, the
attention kernel of ``csrc/mha.cu`` and a GEMM with a residual + LayerNorm
epilogue, in turn), or for float32 activations (the default model
configuration) their float32 twins in ``csrc/layer_fused_f32.cu`` and
``csrc/mha_f32.cu``, or raises (any other dtype raises too). The plain
versions mirror ``layer_fused.py``'s ``_matmul``,
``_layer_norm``, ``_mha_block``, ``_self_block``, ``_cross_tail`` and, for
the stem, ``models/hft.py::fused_stem``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops.precision import full_f32

_LN_EPS = 1e-5  # torch nn.LayerNorm default, the reference's eps
_LOG2E = 1.4426950408889634

# What the CUDA kernels take (csrc/layer_fused.cu, csrc/mha.cu).
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_MAX_HID = 256   # the LayerNorm epilogue owns a full row
KERNEL_MAX_KEYS = 256  # Q, K and V of a (sequence, head) sit in shared memory


def check_geometry(name: str, hid: int, n_heads: int, lq: int, lk: int,
                   pf: int | None = None) -> None:
    """Raise unless the kernels take ``n_heads`` heads over ``hid``
    with ``lq`` queries and ``lk`` keys a sequence, and with ``pf`` (a
    layer's FFN width) the layer kernels' widths."""
    bad = (hid % n_heads or hid // n_heads not in KERNEL_HEAD_DIMS
           or max(lq, lk) > KERNEL_MAX_KEYS)
    if pf is not None:
        bad = bad or hid > KERNEL_MAX_HID or pf % 32
    if bad:
        raise ValueError(
            f"{name}: kernels need head_dim in {KERNEL_HEAD_DIMS}, <= "
            f"{KERNEL_MAX_KEYS} queries and keys"
            + ("" if pf is None else f", hid <= {KERNEL_MAX_HID} and pf % 32 "
               f"== 0") + f"; got hid {hid}, {n_heads} heads, {lq} queries, "
            f"{lk} keys" + ("" if pf is None else f", pf {pf}"))


class EncoderLayerParams(NamedTuple):
    """Weights of one self-attention block: packed Q/K/V ``wqkv [hid,
    3*hid]``, output projection ``wo``, the SHARED LayerNorm ``g/b``
    (float32) and the FFN ``w1/b1/w2/b2``."""

    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


class CrossLayerParams(NamedTuple):
    """Weights of one decoder block: self-attention ``wsqkv/bsqkv`` and
    ``wso/bso`` (zero-size / unused placeholders for layer zero), the
    cross-attention query ``wq/bq``, packed cross K/V ``wkv/bkv`` applied to
    the encoder stream, output projection ``wo/bo``, shared LayerNorm
    ``g/b`` and the FFN."""

    wsqkv: torch.Tensor
    bsqkv: torch.Tensor
    wso: torch.Tensor
    bso: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wkv: torch.Tensor
    bkv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def _scale(hid: int, n_heads: int) -> float:
    return 1.0 / float(hid // n_heads) ** 0.5


# ----------------------------------------------------------- plain versions --

def sqrt_hid(hid: int, dt) -> torch.Tensor:
    """sqrt(hid) as an f32 scalar rounded to ``dt`` (the embedding scale)."""
    return torch.tensor(math.sqrt(hid), dtype=torch.float32).to(dt)


def fused_stem(spec, k_eff, b_eff, dtype):
    """The 65-tap stem on ``spec [B, n_bin, total]`` -> ``[B, n_frame, n_bin,
    hid]`` embeddings in ``dtype`` (before the position embedding). The
    convolution runs in IEEE f32 (cuDNN would default to TF32 on the card);
    the result is rounded to ``dtype`` before the bias add."""
    B, n_bin, total = spec.shape
    n_proc, hid = k_eff.shape
    with full_f32():
        emb = F.conv1d(spec.float().reshape(B * n_bin, 1, total),
                       k_eff.t().unsqueeze(1))      # [B*n_bin, hid, n_frame]
    emb = emb.to(dtype) + b_eff.to(dtype)[:, None]
    n_frame = total - n_proc + 1
    return emb.reshape(B, n_bin, hid, n_frame).permute(0, 3, 1, 2)


def stem_embed_plain(spec_t, keff, beff, pos, n_frame: int, dtype):
    """Stem + sqrt(hid) scale + frequency position embedding on frame-major
    ``spec_t [B, total, n_bin]`` -> ``[B * n_frame, n_bin, hid]`` in
    ``dtype`` (the plain version of ``csrc/stem_embed.cu``)."""
    n_proc, hid = keff.shape
    spec = spec_t[:, :n_frame + n_proc - 1].transpose(1, 2)
    emb = fused_stem(spec, keff, beff, dtype)
    B, _, n_bin, _ = emb.shape
    return (emb.reshape(B * n_frame, n_bin, hid) * sqrt_hid(hid, dtype)
            + pos.to(dtype))


def _matmul(x, w, b):
    """Projection with f32 accumulation, cast to the storage dtype BEFORE
    the bias add, bias added in that dtype."""
    return torch.matmul(x, w).to(x.dtype) + b.to(x.dtype)


def _layer_norm(x, g, b):
    """Post-LN with f32 two-pass statistics, output in x.dtype."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    var = (xf - m).square().mean(-1, keepdim=True)
    y = (xf - m) * torch.rsqrt(var + _LN_EPS)
    return (y * g + b).to(x.dtype)


def _head_attention(qh, kh, vh, scale):
    """One head: f32 scores x scale*log2e, exp2 softmax with the
    normalisation deferred; returns (o_f32, l)."""
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        * (scale * _LOG2E)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(qh.dtype).float(), vh.float())
    return o, l


def _mha_block(q, k, v, n_heads, scale):
    """Per-head attention on ``[n, L, hid]`` blocks; heads are column
    slices of the flat projection layout."""
    d = q.shape[-1] // n_heads
    outs = []
    for h in range(n_heads):
        sl = slice(h * d, (h + 1) * d)
        o, l = _head_attention(q[..., sl], k[..., sl], v[..., sl], scale)
        outs.append((o / l).to(q.dtype))
    return torch.cat(outs, dim=-1)


def _self_block(x, wqkv, bqkv, wo, bo, g, b, w1, b1, w2, b2, n_heads, scale):
    """x -> post-LN(x + SelfAttn(x)) -> post-LN(. + FFN(.)), shared LN."""
    q, k, v = _matmul(x, wqkv, bqkv).split(x.shape[-1], dim=-1)
    attn = _matmul(_mha_block(q, k, v, n_heads, scale), wo, bo)
    y = _layer_norm(x + attn, g, b)
    ff = _matmul(torch.relu(_matmul(y, w1, b1)), w2, b2)
    return _layer_norm(y + ff, g, b)


def _cross_tail(trg, enc, wq, bq, wkv, bkv, wo, bo, g, b, w1, b1, w2, b2,
                n_heads, scale):
    """Cross-attention + FFN tail shared by both decoder layers."""
    q = _matmul(trg, wq, bq)
    k, v = _matmul(enc, wkv, bkv).split(trg.shape[-1], dim=-1)
    attn = _matmul(_mha_block(q, k, v, n_heads, scale), wo, bo)
    y = _layer_norm(trg + attn, g, b)
    ff = _matmul(torch.relu(_matmul(y, w1, b1)), w2, b2)
    return _layer_norm(y + ff, g, b)


def encoder_layer_plain(x, p: EncoderLayerParams, n_heads: int):
    with full_f32():
        return _self_block(x, *p, n_heads, _scale(x.shape[-1], n_heads))


def encoder_layer_with_stem_plain(spec_t, keff, beff, pos,
                                  p: EncoderLayerParams, n_heads: int,
                                  n_frame: int, out_dtype):
    x = stem_embed_plain(spec_t, keff, beff, pos, n_frame, out_dtype)
    return encoder_layer_plain(x, p, n_heads)


def decoder_layer_zero_plain(trg, enc, p: CrossLayerParams, n_heads: int):
    with full_f32():
        return _cross_tail(trg, enc, *p[4:], n_heads,
                           _scale(trg.shape[-1], n_heads))


def decoder_layer_plain(trg, enc, p: CrossLayerParams, n_heads: int):
    scale = _scale(trg.shape[-1], n_heads)
    with full_f32():
        q, k, v = _matmul(trg, p.wsqkv, p.bsqkv).split(trg.shape[-1], dim=-1)
        sa = _matmul(_mha_block(q, k, v, n_heads, scale), p.wso, p.bso)
        trg = _layer_norm(trg + sa, p.g, p.b)
        return _cross_tail(trg, enc, *p[4:], n_heads, scale)


# ---------------------------------------------------------------- kernels --

def _gemm(a, w, bias, relu=False):
    """``dt(a @ w) + bias`` [then ReLU] on ``a [M, K]`` of dtype ``dt``."""
    (m, k), n = a.shape, w.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    kernels.call(kernels.entry("nylon_gemm_bias", a.dtype), a.data_ptr(),
                 w.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k,
                 int(relu), kernels.stream_of(a))
    return out


def _gemm_res_ln(a, w, bias, res, g, b):
    """``LN(res + (dt(a @ w) + bias))`` with the shared LayerNorm."""
    (m, k), n = a.shape, w.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    kernels.call(kernels.entry("nylon_gemm_res_ln", a.dtype), a.data_ptr(),
                 w.data_ptr(), bias.data_ptr(), res.data_ptr(), g.data_ptr(),
                 b.data_ptr(), out.data_ptr(), m, n, k, _LN_EPS,
                 kernels.stream_of(a))
    return out


def check_rows(name: str, t) -> None:
    """Raise unless the 2-D view ``t`` has a unit column stride, 16-byte
    rows and a 16-byte aligned start (the kernels load rows 16 bytes at a
    time)."""
    if (t.stride(1) != 1 or t.stride(0) * t.element_size() % 16
            or t.data_ptr() % 16):
        raise ValueError(f"{name} must have unit column stride, a row "
                         "stride of a multiple of 16 bytes and a 16-byte "
                         "aligned start")


def _attention(q, k, v, n, n_heads):
    """Attention of ``n`` sequences on row-strided 2-D views ``q [n*Lq,
    hid]`` and ``k, v [n*Lk, hid]`` (column slices of packed projections,
    read in place) -> contiguous ``[n*Lq, hid]``."""
    hid = q.shape[1]
    lq, lk = q.shape[0] // n, k.shape[0] // n
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(f"attention: {name}", t)
    if k.stride(0) != v.stride(0):
        raise ValueError("attention: k and v must share a row stride")
    out = torch.empty((q.shape[0], hid), dtype=q.dtype, device=q.device)
    kernels.call(kernels.entry("nylon_attention", q.dtype), q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), n, lq, lk,
                 n_heads, hid // n_heads,
                 q.stride(0), lq * q.stride(0), k.stride(0), lk * k.stride(0),
                 _scale(hid, n_heads) * _LOG2E, kernels.stream_of(q))
    return out


def weight_shapes(hid: int, pf: int) -> dict[str, tuple[int, ...]]:
    """The shape of every layer weight field the kernels take."""
    return {"wqkv": (hid, 3 * hid), "bqkv": (3 * hid,),
            "wsqkv": (hid, 3 * hid), "bsqkv": (3 * hid,),
            "wso": (hid, hid), "bso": (hid,), "wq": (hid, hid),
            "bq": (hid,), "wkv": (hid, 2 * hid), "bkv": (2 * hid,),
            "wo": (hid, hid), "bo": (hid,), "g": (hid,), "b": (hid,),
            "w1": (hid, pf), "b1": (pf,), "w2": (pf, hid), "b2": (hid,)}


def _check_kernel_args(name, acts, p, fields, n_heads, lk):
    """Raise unless the kernels take these activations (bfloat16 or
    float32, all of one dtype), weights (of that dtype) and geometry."""
    dt = acts[0][1].dtype
    kernels.check_dtype(name, dt)
    for act_name, t in acts:
        kernels.check_cuda(f"{name}: {act_name}", t, dt, ndim=3)
    n, lq, hid = acts[0][1].shape
    if any(t.shape[0] != n or t.shape[2] != hid for _, t in acts):
        raise ValueError(f"{name}: activations disagree on n or hid: "
                         f"{[tuple(t.shape) for _, t in acts]}")
    pf = p.w1.shape[1]
    check_geometry(name, hid, n_heads, lq, lk, pf)
    shapes = weight_shapes(hid, pf)
    for f in fields:
        t = getattr(p, f)
        kernels.check_cuda(f"{name}: {f}", t,
                           torch.float32 if f in ("g", "b") else dt)
        if tuple(t.shape) != shapes[f]:
            raise ValueError(f"{name}: {f} has shape {tuple(t.shape)}, "
                             f"expected {shapes[f]}")


_FFN_LN = ("wo", "bo", "g", "b", "w1", "b1", "w2", "b2")
_CROSS = ("wq", "bq", "wkv", "bkv") + _FFN_LN


def _ffn_tail(attn, res, p):
    """LN(res + attn @ wo) -> LN(. + FFN(.)), on row-major 2-D tensors."""
    y = _gemm_res_ln(attn, p.wo, p.bo, res, p.g, p.b)
    h = _gemm(y, p.w1, p.b1, relu=True)
    return _gemm_res_ln(h, p.w2, p.b2, y, p.g, p.b)


def _cross_tail_cuda(t2, e2, p, n, n_heads):
    hid = t2.shape[1]
    q = _gemm(t2, p.wq, p.bq)
    kv = _gemm(e2, p.wkv, p.bkv)
    attn = _attention(q, kv[:, :hid], kv[:, hid:], n, n_heads)
    return _ffn_tail(attn, t2, p)


def _encoder_layer_cuda(name, x, p, n_heads):
    n, l, hid = x.shape
    _check_kernel_args(name, [("x", x)], p, ("wqkv", "bqkv") + _FFN_LN,
                       n_heads, l)
    x2 = x.view(n * l, hid)
    qkv = _gemm(x2, p.wqkv, p.bqkv)
    attn = _attention(qkv[:, :hid], qkv[:, hid:2 * hid], qkv[:, 2 * hid:],
                      n, n_heads)
    return _ffn_tail(attn, x2, p).view(n, l, hid)


def encoder_layer(x, p: EncoderLayerParams, n_heads: int):
    """Self-attention transformer layer: ``x [n, L, hid] -> [n, L, hid]``
    (ref ``EncoderLayer:222-245``)."""
    if x.device.type == "cpu":
        return encoder_layer_plain(x, p, n_heads)
    with torch.cuda.device(x.device):
        out = _encoder_layer_cuda("encoder_layer", x, p, n_heads)
    kernels.launches["encoder_layer"] += 1
    return out


def _stem_embed(spec_t, keff, beff, pos, n_frame, out_dtype):
    """The stem kernel: ``spec_t [B, total, n_bin]`` f32 -> ``[B * n_frame,
    n_bin, hid]`` in ``out_dtype`` (bfloat16 or float32, as ``pos``)."""
    name = "encoder_layer_with_stem"
    fn = kernels.entry("nylon_stem_embed", out_dtype)
    kernels.check_cuda(f"{name}: spec_t", spec_t, torch.float32, ndim=3)
    kernels.check_cuda(f"{name}: keff", keff, torch.float32, ndim=2)
    kernels.check_cuda(f"{name}: beff", beff, torch.float32, ndim=1)
    kernels.check_cuda(f"{name}: pos", pos, out_dtype, ndim=2)
    B, total, n_bin = spec_t.shape
    n_proc, hid = keff.shape
    if (beff.shape[0] != hid or tuple(pos.shape) != (n_bin, hid)
            or total < n_frame + n_proc - 1 or n_frame % 4 or n_bin % 8
            or hid % 64):
        raise ValueError(
            f"{name}: the stem kernel needs keff [n_proc, hid], beff [hid], "
            f"pos [n_bin, hid], total >= n_frame + n_proc - 1, n_frame % 4 "
            f"== 0, n_bin % 8 == 0 and hid % 64 == 0; got spec_t "
            f"{tuple(spec_t.shape)}, keff {tuple(keff.shape)}, beff "
            f"{tuple(beff.shape)}, pos {tuple(pos.shape)}, n_frame {n_frame}")
    out = torch.empty((B * n_frame, n_bin, hid), dtype=out_dtype,
                      device=spec_t.device)
    kernels.call(fn, spec_t.data_ptr(), keff.data_ptr(), beff.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), B, total, n_bin, n_frame,
                 n_proc, hid, sqrt_hid(hid, out_dtype).item(),
                 kernels.stream_of(spec_t))
    return out


def encoder_layer_with_stem(spec_t, keff, beff, pos, p: EncoderLayerParams,
                            n_heads: int, n_frame: int, out_dtype):
    """Stem + position embedding + first encoder layer.

    ``spec_t [B, total_frames, n_bin]`` (frame-major f32 log-mel), ``keff
    [n_proc, hid]`` / ``beff [hid]`` the collapsed 65-tap stem (see
    ``models.hft.stem_effective_kernel``), ``pos [n_bin, hid]`` the
    frequency position embedding. Returns ``[B * n_frame, n_bin, hid]`` in
    ``out_dtype``: ``encoder_layer`` applied to the embedded spectrogram.
    The kernels take ``out_dtype`` bfloat16 or float32.
    """
    if spec_t.device.type == "cpu":
        return encoder_layer_with_stem_plain(spec_t, keff, beff, pos, p,
                                             n_heads, n_frame, out_dtype)
    kernels.check_dtype("encoder_layer_with_stem", out_dtype)
    with torch.cuda.device(spec_t.device):
        x = _stem_embed(spec_t, keff, beff, pos, n_frame, out_dtype)
        out = _encoder_layer_cuda("encoder_layer_with_stem", x, p, n_heads)
    kernels.launches["encoder_layer_with_stem"] += 1
    return out


def decoder_layer_zero(trg, enc, p: CrossLayerParams, n_heads: int):
    """Cross-attention-only decoder layer (ref ``DecoderLayer_Zero:247-272``):
    ``trg [n, Lq, hid]`` attends to ``enc [n, Lk, hid]``."""
    if trg.device.type == "cpu":
        return decoder_layer_zero_plain(trg, enc, p, n_heads)
    n, lq, hid = trg.shape
    _check_kernel_args("decoder_layer_zero", [("trg", trg), ("enc", enc)], p,
                       _CROSS, n_heads, enc.shape[1])
    with torch.cuda.device(trg.device):
        out = _cross_tail_cuda(trg.view(n * lq, hid),
                               enc.view(-1, hid), p, n, n_heads)
    kernels.launches["decoder_layer_zero"] += 1
    return out.view(n, lq, hid)


def decoder_layer(trg, enc, p: CrossLayerParams, n_heads: int):
    """Self + cross decoder layer (ref ``DecoderLayer:274-306``)."""
    if trg.device.type == "cpu":
        return decoder_layer_plain(trg, enc, p, n_heads)
    n, lq, hid = trg.shape
    _check_kernel_args("decoder_layer", [("trg", trg), ("enc", enc)], p,
                       ("wsqkv", "bsqkv", "wso", "bso") + _CROSS, n_heads,
                       max(lq, enc.shape[1]))
    with torch.cuda.device(trg.device):
        t2 = trg.view(n * lq, hid)
        qkv = _gemm(t2, p.wsqkv, p.bsqkv)
        sa = _attention(qkv[:, :hid], qkv[:, hid:2 * hid], qkv[:, 2 * hid:],
                        n, n_heads)
        t2 = _gemm_res_ln(sa, p.wso, p.bso, t2, p.g, p.b)
        out = _cross_tail_cuda(t2, enc.view(-1, hid), p, n, n_heads)
    kernels.launches["decoder_layer"] += 1
    return out.view(n, lq, hid)
