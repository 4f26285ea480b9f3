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
``csrc/mha_f32.cu``, or raises (any other dtype raises too). The float32
GEMM kernels multiply on the tensor cores as 3xTF32 and read each weight
matrix as its TF32 pair (:func:`tf32_pair`, packed once by
``infer/engine.py::pack_params`` and handed to the layers as ``tf32``;
a float32 GEMM on the card without its pair raises). The plain
versions mirror ``layer_fused.py``'s ``_matmul``,
``_layer_norm``, ``_mha_block``, ``_self_block``, ``_cross_tail`` and, for
the stem, ``models/hft.py::fused_stem``. ``gemm_bias_plain`` and
``gemm_res_ln_plain`` are the plain twins of the two GEMM kernels alone
(``chip_smoke.py`` (o) holds the kernels to them); ``check_gemm`` refuses,
before the library loads, the shapes those kernels do not take.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

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
    banded convolution runs as one IEEE f32 product of the 65-tap windows
    (a strided view of ``spec``) with ``k_eff``; the result is rounded to
    ``dtype`` before the bias add.

    A product and not a cuDNN convolution: with the convolution, one
    train step run twice from one state on the card gave ``conv.weight``
    and ``tok_embedding_freq.weight`` gradients that differ (cuDNN's
    weight-gradient algorithm; ``tools/step_ab.py --twice``), and two
    identical training runs parted in their first epoch. cuBLAS's
    products on one stream give the same bits from run to run, so
    training is deterministic with no flag from the caller."""
    B, n_bin, total = spec.shape
    n_proc, hid = k_eff.shape
    n_frame = total - n_proc + 1
    windows = spec.float().reshape(B * n_bin, total).unfold(1, n_proc, 1)
    with full_f32():
        emb = torch.matmul(windows, k_eff)          # [B*n_bin, n_frame, hid]
    emb = emb.to(dtype) + b_eff.to(dtype)
    return emb.reshape(B, n_bin, n_frame, hid).transpose(1, 2)


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


def _site_mask(site, y) -> torch.Tensor:
    """The keep mask of a GEMM kernel's dropout site on ``y``'s rows (its
    last axis the site's columns)."""
    # attention imports this module, so its hash is imported on use
    from nylon_amt_tpu_torch.ops.attention import keep_values

    n = y.shape[-1]
    return keep_values(site.key, site.thresh, site.scale, site.half,
                       y.numel() // n, n, y.dtype, y.device).reshape(y.shape)


def gemm_bias_plain(a, w, bias, relu=False, site=None):
    """The plain twin of the GEMM + bias kernel (``csrc/layer_fused.cu``
    ``gemm_bias_kernel``, ``nylon_gemm_bias[_drop]``): ``dt(a @ w) + bias``
    [, ReLU] [, times the keep mask of ``site``] on ``a [M, K]`` of dtype
    ``dt``. ``site``: the kernel's dropout site (key, thresh, scale, half:
    ``layer_fused_train._Site``) or None."""
    with full_f32():
        y = _matmul(a, w, bias)
    if relu:
        y = torch.relu(y)
    if site is not None:
        y = y * _site_mask(site, y)
    return y


def gemm_res_ln_plain(a, w, bias, res, g, b, site=None):
    """The plain twin of the GEMM + residual + LayerNorm kernel
    (``gemm_res_ln_kernel``, ``nylon_gemm_res_ln[_train]``): returns ``(out,
    pre)``, ``pre = res + (dt(a @ w) + bias) [x keep of site]`` and ``out =
    LN(pre)`` with the shared (g, b)."""
    with full_f32():
        y = _matmul(a, w, bias)
    if site is not None:
        y = y * _site_mask(site, y)
    pre = res + y
    return _layer_norm(pre, g, b), pre


# ------------------------------------------------------ the TF32 weights --

def _split(x):
    """(big, small) of f32 ``x``: ``big`` = each value rounded to nearest at
    TF32's 11 significant bits (Veltkamp's split: ``c = x * 8193``, ``big
    = c - (c - x)``), ``small`` = ``x - big`` (exact) with half a TF32 ulp
    added to its bits (the tensor core drops the low 13): the split of
    ``csrc/tf32.cuh``, bit for bit. Each op is one rounded f32 op."""
    c = x * 8193.0
    big = c - (c - x)
    small = ((x - big).view(torch.int32) + 0x1000).view(torch.float32)
    return big, small


def tf32_pair(w, nt: bool = False):
    """The float32 GEMM kernels' form of a weight ``w [K, N]``: the K-major
    TF32 pair ``[2, N, K]`` (big, small) of ``w^T`` (TF32 ``wgmma`` reads
    shared-memory operands K-major only); with ``nt`` the pair ``[2, K,
    N]`` of ``w`` itself, the dX GEMM's (``dy @ w^T`` reduces over N)."""
    return torch.stack(_split((w if nt else w.t()).float().contiguous()))


def pack_tf32(p, nt: bool = False) -> dict[str, tuple]:
    """The TF32 pair ``(big, small)``, each ``[N, K]``, of every weight
    matrix of the layer parameters ``p`` (``EncoderLayerParams`` or
    ``CrossLayerParams``), by field name: :func:`tf32_pair`'s values,
    split at once for the whole layer (a handful of launches, not a
    handful a matrix) into two buffers that the pairs view. With ``nt``
    (training) the same split also gives the dX GEMM's pair ``[K, N]`` of
    each matrix, under ``name + "_nt"``: one more copy a matrix, in the same
    buffer."""
    mats = [(f, t) for f, t in zip(p._fields, p) if t.dim() == 2
            and t.numel()]
    size = sum(t.numel() for _, t in mats)
    wt = torch.empty((2 if nt else 1) * size, dtype=torch.float32,
                     device=mats[0][1].device)
    views, off = {}, 0
    for f, t in mats:          # w^T of each matrix, K-major, one copy each
        k, n = t.shape
        views[f] = (off, n, k)
        wt[off:off + n * k].view(n, k).copy_(t.t())
        off += n * k
    if nt:
        for f, t in mats:      # and w itself, for dX
            k, n = t.shape
            views[f + "_nt"] = (off, k, n)
            wt[off:off + n * k].view(k, n).copy_(t)
            off += n * k
    big, small = _split(wt)
    return {f: (big[o:o + r * c].view(r, c), small[o:o + r * c].view(r, c))
            for f, (o, r, c) in views.items()}


def _pair(tf32, name):
    """The TF32 pair of matrix ``name`` from a :func:`pack_tf32` dict, or
    None (bfloat16, which reads the matrix itself)."""
    return None if tf32 is None else tf32[name]


# ---------------------------------------------------------------- kernels --

# What the GEMM entry points take, by activation dtype: K and N multiples
# (csrc/layer_fused.cu: K % 32, N % 8; csrc/layer_fused_f32.cu: K % 4,
# N % 4); the LayerNorm GEMM also N <= KERNEL_MAX_HID.
_GEMM_MULTIPLES = {torch.bfloat16: (32, 8), torch.float32: (4, 4)}


def check_gemm(name: str, m: int, k: int, n: int, dtype,
               ln: bool = False) -> None:
    """Raise ``ValueError`` unless the GEMM kernels take ``a [m, k] @ w [k,
    n]`` in ``dtype`` (with ``ln``, the residual + LayerNorm one): what the
    C entry points would refuse, refused before the library is loaded."""
    kernels.check_dtype(name, dtype)
    mk, mn = _GEMM_MULTIPLES[dtype]
    if (m <= 0 or k <= 0 or n <= 0 or k % mk or n % mn
            or (ln and n > KERNEL_MAX_HID)):
        raise ValueError(
            f"{name}: the {dtype} GEMM kernels take K % {mk} == 0, N % {mn} "
            f"== 0" + (f" and N <= {KERNEL_MAX_HID}" if ln else "")
            + f"; got M {m}, K {k}, N {n}")


def gemm_weight(name: str, w, pair, dtype, nt: bool = False) -> tuple:
    """The pointers a GEMM entry point takes for the weight ``w [K, N]``:
    ``w``'s for bfloat16; for float32 those of its TF32 pair ``(big,
    small)``, each ``[N, K]`` (with ``nt``, the dX GEMM's, each ``[K,
    N]``): ``pair`` (a :func:`pack_tf32` entry or a :func:`tf32_pair`).
    Raises for a ``pair`` of another shape, dtype or device, and on the
    card for a missing one: the callers pack once (``pack_params``, the
    training step's ``Weights``). Off the card (a meta tensor, or a CPU
    tensor handed to a GEMM wrapper itself), where no kernel runs on the
    data, a missing pair is made here so that the call goes on to the
    kernel loader."""
    if dtype != torch.float32:
        return (w.data_ptr(),)
    k, n = w.shape
    shape = (k, n) if nt else (n, k)
    if pair is None and w.device.type == "cuda":
        raise ValueError(
            f"{name}: the float32 kernels read the weight [{k}, {n}] as its "
            f"TF32 pair, and none was given (pack_tf32 / tf32_pair)")
    halves = tf32_pair(w, nt) if pair is None else pair
    if len(halves) != 2 or any(
            tuple(h.shape) != shape or h.dtype != torch.float32
            or not h.is_contiguous() or h.device != w.device
            for h in halves):
        raise ValueError(
            f"{name}: the float32 kernels read the weight [{k}, {n}] as its "
            f"TF32 pair, two contiguous float32 {list(shape)} on {w.device} "
            f"(tf32_pair); got "
            + ", ".join(f"{tuple(h.shape)} {h.dtype} on {h.device}"
                        for h in halves))
    return tuple(h.data_ptr() for h in halves)


def count_f32_gemm(name: str, dtype) -> None:
    """Count a launch of the float32 GEMM kernel ``name``."""
    if dtype == torch.float32:
        kernels.launches[f"{name}_f32"] += 1


def _gemm(a, w, bias, relu=False, pair=None):
    """``dt(a @ w) + bias`` [then ReLU] on ``a [M, K]`` of dtype ``dt``
    (float32: ``pair`` is ``tf32_pair(w)``)."""
    (m, k), n = a.shape, w.shape[1]
    check_gemm("gemm_bias", m, k, n, a.dtype)
    wk = gemm_weight("gemm_bias", w, pair, a.dtype)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    kernels.call(kernels.entry("nylon_gemm_bias", a.dtype), a.data_ptr(),
                 *wk, bias.data_ptr(), out.data_ptr(), m, n, k, int(relu),
                 kernels.stream_of(a))
    count_f32_gemm("gemm_bias", a.dtype)
    return out


def _gemm_ffma(a, w, bias):
    """``a @ w + bias`` in float32 on the CUDA cores (IEEE f32 products
    summed over k in order): the stem layer's QKV projection, in inference
    and in training."""
    (m, k), n = a.shape, w.shape[1]
    check_gemm("gemm_bias", m, k, n, a.dtype)
    if a.dtype != torch.float32 or w.shape[0] != k or bias.shape != (n,):
        raise ValueError(f"gemm_bias_ffma: takes float32 a [M, K], w [K, N], "
                         f"bias [N]; got {a.dtype} {tuple(a.shape)}, "
                         f"{tuple(w.shape)}, {tuple(bias.shape)}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    kernels.call("nylon_gemm_bias_ffma_f32", a.data_ptr(), w.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), m, n, k, 0,
                 kernels.stream_of(a))
    kernels.launches["gemm_bias_ffma_f32"] += 1
    return out


def _gemm_res_ln(a, w, bias, res, g, b, pair=None):
    """``LN(res + (dt(a @ w) + bias))`` with the shared LayerNorm
    (float32: ``pair`` is ``tf32_pair(w)``)."""
    (m, k), n = a.shape, w.shape[1]
    check_gemm("gemm_res_ln", m, k, n, a.dtype, ln=True)
    wk = gemm_weight("gemm_res_ln", w, pair, a.dtype)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    kernels.call(kernels.entry("nylon_gemm_res_ln", a.dtype), a.data_ptr(),
                 *wk, bias.data_ptr(), res.data_ptr(), g.data_ptr(),
                 b.data_ptr(), out.data_ptr(), m, n, k, _LN_EPS,
                 kernels.stream_of(a))
    count_f32_gemm("gemm_res_ln", a.dtype)
    return out


def check_rows(name: str, t) -> None:
    """Raise unless the 2-D view ``t`` has a unit column stride, 16-byte
    rows that do not overlap and a 16-byte aligned start (the kernels load
    rows 16 bytes at a time, the attention by TMA, which takes nothing
    else)."""
    if (t.stride(1) != 1 or t.stride(0) * t.element_size() % 16
            or t.stride(0) < t.shape[1] or t.data_ptr() % 16):
        raise ValueError(f"{name} must have unit column stride, a row "
                         "stride of a multiple of 16 bytes and at least "
                         "its columns, and a 16-byte aligned start")


def check_attention_views(q, k, v) -> None:
    """Raise unless the attention kernels take the views ``q``, ``k``,
    ``v`` (:func:`check_rows`; ``k`` and ``v`` sharing a row stride)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(f"attention: {name}", t)
    if k.stride(0) != v.stride(0):
        raise ValueError("attention: k and v must share a row stride")


def _attention(q, k, v, n, n_heads, ffma_scores=False, drop=None):
    """Attention of ``n`` sequences on row-strided 2-D views ``q [n*Lq,
    hid]`` and ``k, v [n*Lk, hid]`` (column slices of packed projections,
    read in place) -> contiguous ``[n*Lq, hid]``. ``ffma_scores``: float32
    with the scores on FFMA, for the layer that the stem feeds (its scores
    reach ~2^14 in log2 units, where only the plain GEMM's fmaf chain over
    d keeps the layer within 2e-5 of the plain one: csrc/mha_f32.cu).
    ``drop``: ``(seed_mix, head_tag0, thresh, keep, half)`` of a dropout
    site on the probabilities, or None."""
    hid = q.shape[1]
    lq, lk = q.shape[0] // n, k.shape[0] // n
    check_attention_views(q, k, v)
    out = torch.empty((q.shape[0], hid), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), n, lq,
            lk, n_heads, hid // n_heads, q.stride(0), lq * q.stride(0),
            k.stride(0), lk * k.stride(0), _scale(hid, n_heads) * _LOG2E)
    if ffma_scores and q.dtype == torch.float32:
        kernels.call("nylon_attention_ffma_f32", *args, int(drop is not None),
                     *(drop or (0, 0, 0, 1.0, 0)), kernels.stream_of(q))
    elif drop is not None:
        kernels.call(kernels.entry("nylon_attention_drop", q.dtype), *args,
                     *drop, kernels.stream_of(q))
    else:
        kernels.call(kernels.entry("nylon_attention", q.dtype), *args,
                     kernels.stream_of(q))
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


def _ffn_tail(attn, res, p, tf32):
    """LN(res + attn @ wo) -> LN(. + FFN(.)), on row-major 2-D tensors."""
    y = _gemm_res_ln(attn, p.wo, p.bo, res, p.g, p.b,
                     pair=_pair(tf32, "wo"))
    h = _gemm(y, p.w1, p.b1, relu=True, pair=_pair(tf32, "w1"))
    return _gemm_res_ln(h, p.w2, p.b2, y, p.g, p.b,
                        pair=_pair(tf32, "w2"))


def _cross_tail_cuda(t2, e2, p, n, n_heads, tf32):
    hid = t2.shape[1]
    q = _gemm(t2, p.wq, p.bq, pair=_pair(tf32, "wq"))
    kv = _gemm(e2, p.wkv, p.bkv, pair=_pair(tf32, "wkv"))
    attn = _attention(q, kv[:, :hid], kv[:, hid:], n, n_heads)
    return _ffn_tail(attn, t2, p, tf32)


def _encoder_layer_cuda(name, x, p, n_heads, tf32, stem=False):
    n, l, hid = x.shape
    _check_kernel_args(name, [("x", x)], p, ("wqkv", "bqkv") + _FFN_LN,
                       n_heads, l)
    x2 = x.view(n * l, hid)
    if stem and x.dtype == torch.float32:
        # The stem layer's scores reach ~2^14 in log2 units, where the plain
        # f32 layer is itself ~8e-5 from a float64 truth: the layer stays
        # within 2e-5 of it only with the plain GEMM's IEEE f32 products
        # summed over k in order (3xTF32 reads 1.4e-4 / 4.3e-4; exact
        # products with f64 sums, closer to the truth, 7.8e-5 / 2.4e-4:
        # chip_smoke.py (n.2) reads both distances; PERF.md). Its attention
        # scores stay on FFMA for the same reason. The training layer fed by
        # the stem takes the same route (layer_fused_train, stem=True).
        qkv = _gemm_ffma(x2, p.wqkv, p.bqkv)
    else:
        qkv = _gemm(x2, p.wqkv, p.bqkv, pair=_pair(tf32, "wqkv"))
    attn = _attention(qkv[:, :hid], qkv[:, hid:2 * hid], qkv[:, 2 * hid:],
                      n, n_heads, ffma_scores=stem)
    return _ffn_tail(attn, x2, p, tf32).view(n, l, hid)


def encoder_layer(x, p: EncoderLayerParams, n_heads: int, tf32=None):
    """Self-attention transformer layer: ``x [n, L, hid] -> [n, L, hid]``
    (ref ``EncoderLayer:222-245``). ``tf32``: :func:`pack_tf32` of ``p``,
    which float32 on the card requires."""
    if x.device.type == "cpu":
        return encoder_layer_plain(x, p, n_heads)
    with torch.cuda.device(x.device):
        out = _encoder_layer_cuda("encoder_layer", x, p, n_heads, tf32)
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
            or hid % 4):
        raise ValueError(
            f"{name}: the stem kernel needs keff [n_proc, hid], beff [hid], "
            f"pos [n_bin, hid], total >= n_frame + n_proc - 1, n_frame % 4 "
            f"== 0, n_bin % 8 == 0 and hid % 4 == 0; got spec_t "
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
                            n_heads: int, n_frame: int, out_dtype,
                            tf32=None):
    """Stem + position embedding + first encoder layer.

    ``spec_t [B, total_frames, n_bin]`` (frame-major f32 log-mel), ``keff
    [n_proc, hid]`` / ``beff [hid]`` the collapsed 65-tap stem (see
    ``models.hft.stem_effective_kernel``), ``pos [n_bin, hid]`` the
    frequency position embedding. Returns ``[B * n_frame, n_bin, hid]`` in
    ``out_dtype``: ``encoder_layer`` applied to the embedded spectrogram.
    The kernels take ``out_dtype`` bfloat16 or float32 (``tf32`` as for
    ``encoder_layer``).
    """
    if spec_t.device.type == "cpu":
        return encoder_layer_with_stem_plain(spec_t, keff, beff, pos, p,
                                             n_heads, n_frame, out_dtype)
    kernels.check_dtype("encoder_layer_with_stem", out_dtype)
    with torch.cuda.device(spec_t.device):
        x = _stem_embed(spec_t, keff, beff, pos, n_frame, out_dtype)
        out = _encoder_layer_cuda("encoder_layer_with_stem", x, p, n_heads,
                                  tf32, stem=True)
    kernels.launches["encoder_layer_with_stem"] += 1
    return out


def decoder_layer_zero(trg, enc, p: CrossLayerParams, n_heads: int,
                       tf32=None):
    """Cross-attention-only decoder layer (ref ``DecoderLayer_Zero:247-272``):
    ``trg [n, Lq, hid]`` attends to ``enc [n, Lk, hid]`` (``tf32`` as for
    ``encoder_layer``)."""
    if trg.device.type == "cpu":
        return decoder_layer_zero_plain(trg, enc, p, n_heads)
    n, lq, hid = trg.shape
    _check_kernel_args("decoder_layer_zero", [("trg", trg), ("enc", enc)], p,
                       _CROSS, n_heads, enc.shape[1])
    with torch.cuda.device(trg.device):
        out = _cross_tail_cuda(trg.view(n * lq, hid), enc.view(-1, hid), p,
                               n, n_heads, tf32)
    kernels.launches["decoder_layer_zero"] += 1
    return out.view(n, lq, hid)


def decoder_layer(trg, enc, p: CrossLayerParams, n_heads: int, tf32=None):
    """Self + cross decoder layer (ref ``DecoderLayer:274-306``; ``tf32``
    as for ``encoder_layer``)."""
    if trg.device.type == "cpu":
        return decoder_layer_plain(trg, enc, p, n_heads)
    n, lq, hid = trg.shape
    _check_kernel_args("decoder_layer", [("trg", trg), ("enc", enc)], p,
                       ("wsqkv", "bsqkv", "wso", "bso") + _CROSS, n_heads,
                       max(lq, enc.shape[1]))
    with torch.cuda.device(trg.device):
        t2 = trg.view(n * lq, hid)
        qkv = _gemm(t2, p.wsqkv, p.bsqkv, pair=_pair(tf32, "wsqkv"))
        sa = _attention(qkv[:, :hid], qkv[:, hid:2 * hid], qkv[:, 2 * hid:],
                        n, n_heads)
        t2 = _gemm_res_ln(sa, p.wso, p.bso, t2, p.g, p.b,
                          pair=_pair(tf32, "wso"))
        out = _cross_tail_cuda(t2, enc.view(-1, hid), p, n, n_heads, tf32)
    kernels.launches["decoder_layer"] += 1
    return out.view(n, lq, hid)
