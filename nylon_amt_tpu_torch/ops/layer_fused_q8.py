"""int8 (W8A8) transformer layers of the inference engine (K13) and their
plain versions.

Port of :mod:`nylon_amt_tpu.ops.layer_fused_q8`: the W8A8 twins of K2-K5
with the signatures of :mod:`nylon_amt_tpu_torch.ops.layer_fused`.

* Weights: symmetric per-output-channel int8, quantized once at pack time
  (:func:`quantize_weight`) from the compute-dtype weights.
* Activations: dynamic symmetric per-row int8 (:func:`_quant_rows`).
* Attention: Q and K per row over the full ``hid`` (shared by the heads),
  V per column over the whole key sequence; int8 QK^T and PV products,
  scores dequantized to f32 before the softmax, probabilities re-quantized
  with the static scale 127.

Everything else keeps the bf16 path's numerics (f32 LayerNorm statistics,
f32 softmax, residuals in the compute dtype).

A CPU tensor takes the plain version; any other device launches the
hand-written kernels of ``csrc/layer_fused_q8.cu`` (a row quantizer, a
transposing column quantizer for V, an s8 x s8 -> s32 tensor-core GEMM with
a dequantizing epilogue that can also quantize rows of its output, the same
GEMM with the residual + shared LayerNorm epilogue, and an int8 attention
kernel for head_dim 32 or 64 that writes its output's row codes), each for
bfloat16 or float32 activations (the compute dtype), or raises. The plain
versions follow the JAX bodies op for op; the kernels' are named
(:func:`gemm_q8_bias_plain`, :func:`gemm_q8_bias_codes_plain`,
:func:`gemm_q8_res_ln_plain`, :func:`attention_q8_plain`).

On the card a tensor that a GEMM reads as codes leaves the kernel that
makes it as codes (the row quantization folded into its epilogue: Q and K
of the QKV product, the cross Q and K, the FFN hidden, the heads' output,
each layer's output when the caller asks for it with ``codes_out``), so a
layer quantizes with the row quantizer only an input that no kernel before
it wrote as codes. The layers take their inputs' codes as keyword
arguments (``x_codes``, ``trg_codes``, ``enc_codes``) and hand back their
output's with ``codes_out``; ``infer/engine.py::forward`` threads them from
layer to layer. The codes are those :func:`_quant_rows` gives of the same
values, bit for bit, on either device.

The GEMM kernels read each weight matrix K-major, as ``W^T [N, K]``
(8-bit ``wgmma`` reads shared-memory operands K-major only): the layers on
the card take these packs as ``wt`` (:func:`pack_wt`, made once by
``infer/engine.py::pack_params``), beside the ``[K, N]`` codes that
``Q8EncoderLayerParams`` / ``Q8CrossLayerParams`` keep in JAX's layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import layer_fused as lf
from nylon_amt_tpu_torch.ops.layer_fused import (
    _LN_EPS,
    _LOG2E,
    CrossLayerParams,
    EncoderLayerParams,
    _layer_norm,
    _scale,
)
from nylon_amt_tpu_torch.ops.precision import full_f32

# The plain versions compute the int8 products as f32 matmuls of
# integer-valued tensors: exact while every partial sum stays below 2**24,
# i.e. K * 127**2 < 2**24.
_EXACT_MAX_K = (2 ** 24) // (127 * 127)  # 1040

# What the CUDA kernels take (csrc/layer_fused_q8.cu).
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_MAX_HID = 256    # the LayerNorm epilogue owns a full row
KERNEL_MAX_KEYS = 256   # a head's K and V of a sequence sit in shared memory
KERNEL_KEY_STEP = 4     # a sequence's key scales: a copy of 16-byte rows
KERNEL_MAX_ROW = 1024   # the row quantizer keeps a row in registers
KERNEL_K_STEP = 16      # the GEMMs' K: a TMA row of K bytes (16-byte rows)
KERNEL_N_STEP = 8       # the GEMMs' N: 16-byte output rows
# gemm_q8_bias's codes epilogue: segments of a multiple of 32 columns, at
# least 64, each inside one tile of at most 256 columns; a whole row of up
# to 512 columns over two tiles (the codes only)
KERNEL_MAX_TILE = 256


class Q8EncoderLayerParams(NamedTuple):
    """int8 weights + f32 per-output-channel scales ``[1, n]`` of one
    self-attention block; biases and the LayerNorm stay as packed."""

    wqkv: torch.Tensor   # int8 [hid, 3*hid]
    sqkv: torch.Tensor   # f32  [1, 3*hid]
    bqkv: torch.Tensor
    wo: torch.Tensor
    so: torch.Tensor
    bo: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor


class Q8CrossLayerParams(NamedTuple):
    wsqkv: torch.Tensor
    ssqkv: torch.Tensor
    bsqkv: torch.Tensor
    wso: torch.Tensor
    sso: torch.Tensor
    bso: torch.Tensor
    wq: torch.Tensor
    sq: torch.Tensor
    bq: torch.Tensor
    wkv: torch.Tensor
    skv: torch.Tensor
    bkv: torch.Tensor
    wo: torch.Tensor
    so: torch.Tensor
    bo: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor


def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as one IEEE division per element. ``num / t`` on a tensor
    is ``t.reciprocal() * num`` in PyTorch (two roundings), and CUDA divides
    a tensor by a host scalar as a multiply by its reciprocal: either one
    would move codes away from JAX's ``127.0 / a``."""
    return torch.div(torch.full_like(t, num), t)


def quantize_weight(w):
    """``w [k, n]`` -> (int8 ``[k, n]``, f32 scales ``[1, n]``), symmetric
    per output channel (``w ~= wq * s``)."""
    wf = w.float()
    a = wf.abs().amax(0, keepdim=True)
    s = torch.div(a.clamp_min(1e-30), torch.full_like(a, 127.0))
    # torch.round rounds half to even, as jnp.round does
    return torch.round(torch.div(wf, s)).to(torch.int8), s


def quantize_encoder_params(p: EncoderLayerParams) -> Q8EncoderLayerParams:
    wqkv, sqkv = quantize_weight(p.wqkv)
    wo, so = quantize_weight(p.wo)
    w1, s1 = quantize_weight(p.w1)
    w2, s2 = quantize_weight(p.w2)
    return Q8EncoderLayerParams(
        wqkv=wqkv, sqkv=sqkv, bqkv=p.bqkv, wo=wo, so=so, bo=p.bo,
        g=p.g, b=p.b, w1=w1, s1=s1, b1=p.b1, w2=w2, s2=s2, b2=p.b2)


def quantize_cross_params(p: CrossLayerParams) -> Q8CrossLayerParams:
    """Layer zero's zero-size / all-zero self-attention placeholders are
    quantized too, so the field order stays that of the JAX pack."""
    wsqkv, ssqkv = quantize_weight(p.wsqkv)
    wso, sso = quantize_weight(p.wso)
    wq, sq = quantize_weight(p.wq)
    wkv, skv = quantize_weight(p.wkv)
    wo, so = quantize_weight(p.wo)
    w1, s1 = quantize_weight(p.w1)
    w2, s2 = quantize_weight(p.w2)
    return Q8CrossLayerParams(
        wsqkv=wsqkv, ssqkv=ssqkv, bsqkv=p.bsqkv, wso=wso, sso=sso, bso=p.bso,
        wq=wq, sq=sq, bq=p.bq, wkv=wkv, skv=skv, bkv=p.bkv,
        wo=wo, so=so, bo=p.bo, g=p.g, b=p.b,
        w1=w1, s1=s1, b1=p.b1, w2=w2, s2=s2, b2=p.b2)


def pack_wt(p) -> dict[str, torch.Tensor]:
    """The s8 GEMM kernels' form of a layer's int8 weights: ``W^T [N, K]``
    of every weight matrix of ``p`` (``Q8EncoderLayerParams`` or
    ``Q8CrossLayerParams``, whose codes stay ``[K, N]``), by field name:
    views of one buffer, one copy a matrix. Layer zero's zero-size
    self-attention QKV has none."""
    mats = [(f, t) for f, t in zip(p._fields, p)
            if t.dtype == torch.int8 and t.numel()]
    buf = torch.empty(sum(t.numel() for _, t in mats), dtype=torch.int8,
                      device=mats[0][1].device)
    wt, off = {}, 0
    for f, t in mats:      # K % 16 keeps every view 16-byte aligned
        k, n = t.shape
        wt[f] = buf[off:off + n * k].view(n, k)
        wt[f].copy_(t.t())
        off += n * k
    return wt


# ----------------------------------------------------------- plain versions --

def _quant_rows(x):
    """Dynamic per-row symmetric int8: ``x [..., L, K]`` -> (int8 same
    shape, f32 dequant scale ``[..., L, 1]``). The code is ``round(x * (127
    / a))`` and the scale ``a * (1 / 127)``, in that order, as in JAX:
    ``x / a * 127`` is another number."""
    xf = x.float()
    a = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    q = torch.round(xf * _div(127.0, a)).to(torch.int8)
    return q, a * (1.0 / 127.0)


def _qdot(xq, wq):
    """s8 x s8 -> exact integer sums over the last/first axes, as f32."""
    k = xq.shape[-1]
    assert k <= _EXACT_MAX_K, f"int8 product over K={k} is not exact in f32"
    with full_f32():
        return torch.matmul(xq.float(), wq.float())


def _qlinear_pre(xq, sx, wq, sw, b, dt):
    """int8 rows x int8 weight -> ``dt``: ``(f32(acc) * sx) * sw``, cast to
    ``dt`` BEFORE the bias add, the bias added in ``dt``."""
    y = _qdot(xq, wq) * sx * sw
    return y.to(dt) + b.to(dt)


def _qlinear(x, wq, sw, b, dt):
    xq, sx = _quant_rows(x)
    return _qlinear_pre(xq, sx, wq, sw, b, dt)


def gemm_q8_bias_plain(aq, sa, wq, sw, bias, relu=False):
    """The plain twin of the s8 GEMM + bias kernel (``gemm_q8_bias_kernel``,
    ``nylon_q8_gemm_bias``): JAX's ``_qlinear_pre``, ``dt((f32(aq @ wq) *
    sa) * sw) + bias`` [then ReLU], on the codes ``aq [M, K]`` with their
    row scales ``sa [M]`` and ``wq [K, N]`` with its column scales ``sw [1,
    N]``, in the bias's dtype ``dt``."""
    with full_f32():
        y = _qlinear_pre(aq, sa[:, None], wq, sw, bias, bias.dtype)
    return torch.relu(y) if relu else y


def gemm_q8_bias_codes_plain(aq, sa, wq, sw, bias, relu, seg, n_seg):
    """The plain twin of ``gemm_q8_bias_kernel`` with its codes epilogue:
    returns (out, codes, scales), ``out`` :func:`gemm_q8_bias_plain`'s (the
    kernel writes only its columns from ``n_seg * seg`` on), ``codes [M,
    n_seg * seg]`` and ``scales [n_seg, M]`` :func:`_quant_rows` of each of
    its first ``n_seg`` column segments of ``seg`` columns."""
    out = gemm_q8_bias_plain(aq, sa, wq, sw, bias, relu)
    quant = [_quant_rows(out[:, i * seg:(i + 1) * seg]) for i in range(n_seg)]
    return (out, torch.cat([q for q, _ in quant], dim=1),
            torch.stack([s[:, 0] for _, s in quant]))


def gemm_q8_res_ln_plain(aq, sa, wq, sw, bias, res, g, b, quant_out=False):
    """The plain twin of the s8 GEMM + residual + LayerNorm kernel
    (``gemm_q8_res_ln_kernel``, ``nylon_q8_gemm_res_ln``): returns ``(out,
    codes, scales)``, ``out = LN(res + gemm_q8_bias_plain(...))`` with the
    shared (g, b) in ``res``'s dtype and, with ``quant_out``, its row
    quantization (:func:`_quant_rows`: int8 ``[M, N]``, f32 ``[M]``), else
    None twice."""
    with full_f32():
        out = _layer_norm(res + gemm_q8_bias_plain(aq, sa, wq, sw, bias),
                          g, b)
    if not quant_out:
        return out, None, None
    q, s = _quant_rows(out)
    return out, q, s[:, 0]


def _quant_cols(v):
    """V's quantizer: per column over the key axis of ``v [..., Lk, hid]``
    -> (int8 codes, scale ``[..., 1, hid]`` with P's static 1/127 folded
    in)."""
    vf = v.float()
    av = vf.abs().amax(-2, keepdim=True).clamp_min(1e-12)
    vq = torch.round(vf * _div(127.0, av)).to(torch.int8)
    return vq, av * (1.0 / (127.0 * 127.0))


def attention_q8_plain(qq, sq, kq, sk, vq, sv, n_heads, scale, dt):
    """The plain twin of the int8 attention kernel (``attention_q8_kernel``,
    ``nylon_q8_attention``): ``_mha_block_q8``'s body on the codes of Q and
    K (``qq [bn, Lq, hid]``, ``kq [bn, Lk, hid]``) with their row scales
    ``[bn, L, 1]`` and V's per-column codes ``vq [bn, Lk, hid]`` with their
    scales ``sv [bn, 1, hid]`` (:func:`_quant_cols`), then the row
    quantization of the output: returns (out ``[bn, Lq, hid]`` in ``dt``,
    its codes, its scales ``[bn, Lq, 1]``)."""
    d = qq.shape[-1] // n_heads
    sk_t = sk.transpose(-1, -2)
    sqc = sq * (scale * _LOG2E)
    outs = []
    for h in range(n_heads):
        sl = slice(h * d, (h + 1) * d)
        s_i = _qdot(qq[..., sl], kq[..., sl].transpose(-1, -2))
        s = s_i * sqc * sk_t
        p = torch.exp2(s - s.amax(-1, keepdim=True))   # (0, 1]
        l = p.sum(-1, keepdim=True)                    # of the unquantized p
        pq = torch.round(p * 127.0)
        o = _qdot(pq, vq[..., sl]) * sv[..., sl]
        outs.append((o / l).to(dt))
    out = torch.cat(outs, dim=-1)
    return (out, *_quant_rows(out))


def _mha_block_q8(q, k, v, n_heads, scale):
    """Per-head one-pass attention with int8 score and PV products on
    ``q [bn, Lq, hid]``, ``k/v [bn, Lk, hid]`` in the compute dtype."""
    qq, sq = _quant_rows(q)                 # scales span all heads
    kq, sk = _quant_rows(k)
    vq, sv = _quant_cols(v)
    return attention_q8_plain(qq, sq, kq, sk, vq, sv, n_heads, scale,
                              q.dtype)[0]


def _ffn_ln_q8(res, attn, g, b, w1, s1, b1, w2, s2, b2, dt):
    y = _layer_norm(res + attn, g, b)
    mid = torch.relu(_qlinear(y, w1, s1, b1, dt))
    return _layer_norm(y + _qlinear(mid, w2, s2, b2, dt), g, b)


def _self_block_q8(x, wqkv, sqkv, bqkv, wo, so, bo, g, b, w1, s1, b1,
                   w2, s2, b2, n_heads, scale):
    dt = x.dtype
    q, k, v = _qlinear(x, wqkv, sqkv, bqkv, dt).split(x.shape[-1], dim=-1)
    attn = _qlinear(_mha_block_q8(q, k, v, n_heads, scale), wo, so, bo, dt)
    return _ffn_ln_q8(x, attn, g, b, w1, s1, b1, w2, s2, b2, dt)


def _cross_tail_q8(trg, enc, wq, sq, bq, wkv, skv, bkv, wo, so, bo, g, b,
                   w1, s1, b1, w2, s2, b2, n_heads, scale):
    dt = trg.dtype
    q = _qlinear(trg, wq, sq, bq, dt)
    k, v = _qlinear(enc, wkv, skv, bkv, dt).split(trg.shape[-1], dim=-1)
    attn = _qlinear(_mha_block_q8(q, k, v, n_heads, scale), wo, so, bo, dt)
    return _ffn_ln_q8(trg, attn, g, b, w1, s1, b1, w2, s2, b2, dt)


def encoder_layer_q8_plain(x, p: Q8EncoderLayerParams, n_heads: int):
    with full_f32():
        return _self_block_q8(x, *p, n_heads, _scale(x.shape[-1], n_heads))


def encoder_layer_with_stem_q8_plain(spec_t, keff, beff, pos,
                                     p: Q8EncoderLayerParams, n_heads: int,
                                     n_frame: int, out_dtype):
    x = lf.stem_embed_plain(spec_t, keff, beff, pos, n_frame, out_dtype)
    return encoder_layer_q8_plain(x, p, n_heads)


def decoder_layer_zero_q8_plain(trg, enc, p: Q8CrossLayerParams,
                                n_heads: int):
    with full_f32():
        return _cross_tail_q8(trg, enc, *list(p)[6:], n_heads,
                              _scale(trg.shape[-1], n_heads))


def decoder_layer_q8_plain(trg, enc, p: Q8CrossLayerParams, n_heads: int):
    """The self-attention prologue of ``_dec_kernel_q8``, then the cross
    tail."""
    hid = trg.shape[-1]
    dt = trg.dtype
    scale = _scale(hid, n_heads)
    with full_f32():
        q, k, v = _qlinear(trg, p.wsqkv, p.ssqkv, p.bsqkv, dt).split(hid, -1)
        sa = _qlinear(_mha_block_q8(q, k, v, n_heads, scale), p.wso, p.sso,
                      p.bso, dt)
        trg = _layer_norm(trg + sa, p.g, p.b)
        return _cross_tail_q8(trg, enc, *list(p)[6:], n_heads, scale)


# ---------------------------------------------------------------- kernels --

def quant_rows_cuda(x2):
    """The row quantizer on the card: ``x2 [M, K]`` bf16 or f32 (a row
    stride that is a multiple of 8, unit column stride) -> (int8 ``[M,
    K]``, f32 scales ``[M]``)."""
    m, k = x2.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    s = torch.empty((m,), dtype=torch.float32, device=x2.device)
    kernels.call(kernels.entry("nylon_q8_quant_rows", x2.dtype),
                 x2.data_ptr(), x2.stride(0), m, k, q.data_ptr(),
                 s.data_ptr(), kernels.stream_of(x2))
    return q, s


def _cols_pad(lk: int) -> int:
    """The keys of V's codes a sequence: ``lk`` padded to a multiple of
    32 (the PV product's operand rows)."""
    return -(-lk // 32) * 32


def quant_cols_plain(v2, n: int):
    """The plain twin of V's quantizer kernel (``quant_cols_kernel``,
    ``nylon_q8_quant_cols``): :func:`_quant_cols` of ``v2 [n*Lk, hid]`` in
    the kernel's layout: the codes transposed per sequence, ``[n, hid,
    Lk_pad]`` with zero codes past Lk, and the scales ``[n, hid]``."""
    rows, hid = v2.shape
    lk = rows // n
    vq, sv = _quant_cols(v2.reshape(n, lk, hid))
    vt = torch.zeros((n, hid, _cols_pad(lk)), dtype=torch.int8,
                     device=v2.device)
    vt[:, :, :lk] = vq.transpose(1, 2)
    return vt, sv[:, 0]


def check_quant_cols(name: str, v2, n: int) -> None:
    """Raise ``ValueError`` unless V's quantizer kernel takes ``v2 [n*Lk,
    hid]``: bfloat16 or float32, ``n`` whole sequences of at most
    KERNEL_MAX_KEYS keys (a sequence's slice is one TMA box), hid % 8 ==
    0, and a view TMA can read (``layer_fused.check_rows``)."""
    kernels.check_dtype(name, v2.dtype)
    rows, hid = v2.shape
    if (n <= 0 or rows <= 0 or rows % n or rows // n > KERNEL_MAX_KEYS
            or hid <= 0 or hid % KERNEL_N_STEP):
        raise ValueError(f"{name}: the kernel takes n whole sequences of at "
                         f"most {KERNEL_MAX_KEYS} keys and hid % "
                         f"{KERNEL_N_STEP} == 0; got {rows} rows of {hid} "
                         f"in {n} sequences")
    lf.check_rows(name, v2)


def quant_cols_cuda(v2, n: int):
    """V's quantizer on the card: ``v2 [n*Lk, hid]`` bf16 or f32
    (row-strided: V's columns of the packed QKV or KV output) -> (int8
    codes TRANSPOSED per sequence, ``[n, hid, Lk_pad]`` with the keys
    padded with zero codes to a multiple of 32, the operand layout of the
    attention's PV product; f32 scales ``[n, hid]`` with P's 1/127 folded
    in): :func:`quant_cols_plain`'s, bit for bit."""
    check_quant_cols("quant_cols", v2, n)
    rows, hid = v2.shape
    lk = rows // n
    vt = torch.empty((n, hid, _cols_pad(lk)), dtype=torch.int8,
                     device=v2.device)
    sv = torch.empty((n, hid), dtype=torch.float32, device=v2.device)
    kernels.call(kernels.entry("nylon_q8_quant_cols", v2.dtype),
                 v2.data_ptr(), v2.stride(0), n, lk, hid, vt.data_ptr(),
                 sv.data_ptr(), kernels.stream_of(v2))
    return vt, sv


def tile_width(n: int) -> int:
    """The s8 GEMMs' column tile for an output ``n`` columns wide (the
    fewest tiles of at most 256 columns, each a multiple of 64:
    ``gemm_sm90.cuh::tile_width``)."""
    tiles = -(-n // KERNEL_MAX_TILE)
    width = -(-n // tiles)
    return -(-width // 64) * 64


def codes_tile(n: int, seg: int, n_seg: int, codes_only: bool) -> int:
    """The column tile that ``gemm_q8_bias_kernel``'s codes epilogue takes
    for the row quantization of the first ``n_seg`` segments of ``seg`` of
    ``n`` columns (``csrc/layer_fused_q8.cu::gemm_bias`` / ``codes_tile``),
    or 0 where it takes none (then the wrapper quantizes the T output
    with the row quantizer): a whole row of 257-512 columns, codes only,
    over two tiles of 256; else the first of ``tile_width(n)``, 256, 192,
    128, 64 that holds each segment inside one tile, for one or two
    segments of a multiple of 32 columns, at least 64."""
    if codes_only and n_seg == 1 and seg == n \
            and KERNEL_MAX_TILE < n <= 2 * KERNEL_MAX_TILE:
        return KERNEL_MAX_TILE
    if seg < 64 or seg % 32 or n_seg > 2:
        return 0
    for bn in (tile_width(n), 256, 192, 128, 64):
        if bn >= seg and all(k * seg // bn == ((k + 1) * seg - 1) // bn
                             for k in range(n_seg)):
            return bn
    return 0


def check_gemm_q8(name: str, m: int, k: int, n: int, dtype,
                  ln: bool = False) -> None:
    """Raise ``ValueError`` unless the s8 GEMM kernels take ``aq [m, k] @ wq
    [k, n]`` with ``dtype`` outputs (with ``ln``, the residual + LayerNorm
    one): what the C entry points would refuse, refused before the library
    is loaded."""
    kernels.check_dtype(name, dtype)
    if (m <= 0 or k <= 0 or n <= 0 or k % KERNEL_K_STEP or k > _EXACT_MAX_K
            or n % KERNEL_N_STEP or (ln and n > KERNEL_MAX_HID)):
        raise ValueError(
            f"{name}: the s8 GEMM kernels take K % {KERNEL_K_STEP} == 0, K <= "
            f"{_EXACT_MAX_K}, N % {KERNEL_N_STEP} == 0"
            + (f" and N <= {KERNEL_MAX_HID}" if ln else "")
            + f"; got M {m}, K {k}, N {n}")


def gemm_wt(name: str, wq, wt) -> int:
    """The pointer an s8 GEMM entry point takes for the weight codes ``wq
    [K, N]``: that of their K-major pack ``wt [N, K]`` (a :func:`pack_wt`
    entry). Raises for a missing pack, or one of another shape, dtype,
    layout or device: the callers pack once (``pack_params``), and the
    wrapper never transposes."""
    k, n = wq.shape
    if wt is None:
        raise ValueError(
            f"{name}: the int8 kernels read the weight codes [{k}, {n}] "
            f"K-major, as W^T [{n}, {k}], and none was given (pack_wt)")
    if (tuple(wt.shape) != (n, k) or wt.dtype != torch.int8
            or not wt.is_contiguous() or wt.device != wq.device
            or wt.data_ptr() % 16):
        raise ValueError(
            f"{name}: the int8 kernels read the weight codes [{k}, {n}] as "
            f"W^T, a contiguous 16-byte aligned int8 [{n}, {k}] on "
            f"{wq.device} (pack_wt); got {tuple(wt.shape)} {wt.dtype} on "
            f"{wt.device}")
    return wt.data_ptr()


def _gemm_q8(aq, sa, wq, sw, bias, relu=False, wt=None, *, seg=0,
             n_seg=0, t_out=True):
    """``dt((f32(aq @ wq) * sa) * sw) + bias`` [then ReLU], in the bias's
    dtype ``dt`` (the compute dtype); ``wt``: ``wq``'s K-major pack.

    With ``n_seg``: also the row quantization of the output's first
    ``n_seg`` column segments of ``seg`` columns, from the kernel's
    epilogue; those columns then leave as codes only. Returns (out, codes
    ``[M, n_seg * seg]``, scales ``[n_seg, M]``), ``out [M, N]`` holding
    the other columns, or None with ``t_out`` False (the segments cover the
    row). Where the epilogue takes no such segments (:func:`codes_tile`) the
    row quantizer quantizes each segment of the T output."""
    (m, k), n = aq.shape, wq.shape[1]
    check_gemm_q8("gemm_q8_bias", m, k, n, bias.dtype)
    w_ptr = gemm_wt("gemm_q8_bias", wq, wt)
    entry = kernels.entry("nylon_q8_gemm_bias", bias.dtype)
    stream = kernels.stream_of(aq)
    if not n_seg:
        out = torch.empty((m, n), dtype=bias.dtype, device=aq.device)
        kernels.call(entry, aq.data_ptr(), sa.data_ptr(), w_ptr,
                     sw.data_ptr(), bias.data_ptr(), out.data_ptr(), None,
                     None, m, n, k, int(relu), 0, 0, stream)
        return out
    if not t_out and seg * n_seg != n:
        raise ValueError(f"gemm_q8_bias: {n_seg} segments of {seg} columns "
                         f"do not cover the {n} columns")
    if not codes_tile(n, seg, n_seg, not t_out):
        out = _gemm_q8(aq, sa, wq, sw, bias, relu, wt)
        quant = [quant_rows_cuda(out[:, i * seg:(i + 1) * seg])
                 for i in range(n_seg)]
        return (out if t_out else None,
                torch.cat([q for q, _ in quant], dim=1),
                torch.stack([s for _, s in quant]))
    out = torch.empty((m, n), dtype=bias.dtype, device=aq.device) \
        if t_out else None
    q = torch.empty((m, seg * n_seg), dtype=torch.int8, device=aq.device)
    s = torch.empty((n_seg, m), dtype=torch.float32, device=aq.device)
    kernels.call(entry, aq.data_ptr(), sa.data_ptr(), w_ptr, sw.data_ptr(),
                 bias.data_ptr(), None if out is None else out.data_ptr(),
                 q.data_ptr(), s.data_ptr(), m, n, k, int(relu), seg, n_seg,
                 stream)
    return out, q, s


def _gemm_q8_res_ln(aq, sa, wq, sw, bias, res, g, b, quant_out=False,
                    wt=None):
    """``LN(res + (dt((f32(aq @ wq) * sa) * sw) + bias))`` with the shared
    LayerNorm, in ``res``'s dtype ``dt``; with ``quant_out`` also the
    output's row quantization (the epilogue owns whole rows): returns (out,
    out codes, out scales). ``wt``: ``wq``'s K-major pack."""
    (m, k), n = aq.shape, wq.shape[1]
    check_gemm_q8("gemm_q8_res_ln", m, k, n, res.dtype, ln=True)
    w_ptr = gemm_wt("gemm_q8_res_ln", wq, wt)
    out = torch.empty((m, n), dtype=res.dtype, device=aq.device)
    q = s = None
    if quant_out:
        q = torch.empty((m, n), dtype=torch.int8, device=aq.device)
        s = torch.empty((m,), dtype=torch.float32, device=aq.device)
    kernels.call(kernels.entry("nylon_q8_gemm_res_ln", res.dtype),
                 aq.data_ptr(), sa.data_ptr(), w_ptr, sw.data_ptr(),
                 bias.data_ptr(),
                 res.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                 q.data_ptr() if quant_out else None,
                 s.data_ptr() if quant_out else None, m, n, k, _LN_EPS,
                 kernels.stream_of(aq))
    return out, q, s


def _attention_q8(qq, sq, kq, sk, vt, sv, n, n_heads, dt, t_out=False):
    """int8 attention of ``n`` sequences: Q codes ``qq [n*Lq, hid]`` and K
    codes ``kq [n*Lk, hid]`` (row-strided views) with their row scales
    ``[n*L]``, V^T codes and column scales from :func:`quant_cols_cuda` ->
    (the output ``[n*Lq, hid]`` in ``dt`` with ``t_out``, else None; its
    row codes ``[n*Lq, hid]``; their scales ``[n*Lq]``)."""
    hid = qq.shape[1]
    lq, lk = qq.shape[0] // n, kq.shape[0] // n
    for name, t in (("q", qq), ("k", kq)):
        if t.stride(1) != 1 or t.stride(0) % 16 or t.data_ptr() % 16:
            raise ValueError(f"attention_q8: {name} codes must have unit "
                             "column stride, a row stride that is a "
                             "multiple of 16 and a 16-byte aligned start")
    if lk % KERNEL_KEY_STEP or sk.data_ptr() % 16:
        raise ValueError(f"attention_q8: the kernel copies a sequence's key "
                         f"scales in 16-byte rows: it takes a multiple of "
                         f"{KERNEL_KEY_STEP} keys and 16-byte aligned scales"
                         f"; got {lk} keys")
    dev = qq.device
    out = torch.empty((qq.shape[0], hid), dtype=dt, device=dev) \
        if t_out else None
    codes = torch.empty((qq.shape[0], hid), dtype=torch.int8, device=dev)
    scales = torch.empty((qq.shape[0],), dtype=torch.float32, device=dev)
    kernels.call(kernels.entry("nylon_q8_attention", dt), qq.data_ptr(),
                 qq.stride(0),
                 sq.data_ptr(), kq.data_ptr(), kq.stride(0), sk.data_ptr(),
                 vt.data_ptr(), vt.shape[2], sv.data_ptr(), codes.data_ptr(),
                 scales.data_ptr(), None if out is None else out.data_ptr(),
                 n, lq, lk, n_heads, hid // n_heads,
                 _scale(hid, n_heads) * _LOG2E, kernels.stream_of(qq))
    return out, codes, scales


def check_geometry(name: str, hid: int, n_heads: int, pf: int,
                   lk: int) -> None:
    """Raise unless the int8 kernels take this layer geometry: head_dim 32
    or 64 (the attention of ``csrc/layer_fused_q8.cu`` is its own), hid up
    to 256 (the LayerNorm epilogue owns a full row), pf a multiple of 16
    (the GEMMs' K) up to 1024 (the row quantizer, where the FFN hidden is
    wider than the codes epilogue takes), at most 256 keys and queries, a
    multiple of 4 keys (``lk``: each attention's keys, an int or a tuple).
    JAX's int8 layers take any geometry."""
    lks = lk if isinstance(lk, tuple) else (lk,)
    if (hid % n_heads or hid // n_heads not in KERNEL_HEAD_DIMS
            or hid > KERNEL_MAX_HID
            or pf % KERNEL_K_STEP or pf > KERNEL_MAX_ROW
            or any(k > KERNEL_MAX_KEYS or k % KERNEL_KEY_STEP for k in lks)):
        raise ValueError(
            f"{name}: kernels need head_dim in {KERNEL_HEAD_DIMS}, hid <= "
            f"{KERNEL_MAX_HID}, pf % {KERNEL_K_STEP} == 0 and <= "
            f"{KERNEL_MAX_ROW}, <= {KERNEL_MAX_KEYS} keys and a multiple of "
            f"{KERNEL_KEY_STEP}; got hid {hid}, {n_heads} heads, pf {pf}, "
            f"{lk} keys")


def layer_wt(name: str, fields, wt) -> dict:
    """The K-major packs (:func:`pack_wt`) of the weight matrices among
    ``fields`` that a layer's GEMMs read: ``wt``. A missing one raises: the
    callers pack once (``pack_params``), and the layers never transpose."""
    missing = [f for f in fields if f.startswith("w")
               and (wt is None or f not in wt)]
    if missing:
        raise ValueError(f"{name}: the int8 kernels read the weights K-major "
                         f"(pack_wt), and none was given for {missing}")
    return wt


def _check_kernel_args(name, acts, p, fields, n_heads, lk, wt) -> dict:
    """Raise unless the kernels take these activations (bfloat16 or
    float32, all of one dtype), weights and geometry; returns the weights'
    K-major packs (:func:`layer_wt`)."""
    act_dt = acts[0][1].dtype
    kernels.check_dtype(name, act_dt)
    for act_name, t in acts:
        kernels.check_cuda(f"{name}: {act_name}", t, act_dt, ndim=3)
    n, _, hid = acts[0][1].shape
    if any(t.shape[0] != n or t.shape[2] != hid for _, t in acts):
        raise ValueError(f"{name}: activations disagree on n or hid: "
                         f"{[tuple(t.shape) for _, t in acts]}")
    pf = p.w1.shape[1]
    check_geometry(name, hid, n_heads, pf, lk)
    shapes = lf.weight_shapes(hid, pf)
    for f in fields:
        t = getattr(p, f)
        if f.startswith("w"):
            want, dt = shapes[f], torch.int8
        elif f.startswith("s"):
            want, dt = (1, shapes["w" + f[1:]][1]), torch.float32
        else:
            want = shapes[f]
            dt = torch.float32 if f in ("g", "b") else act_dt
        kernels.check_cuda(f"{name}: {f}", t, dt)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {f} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    return layer_wt(name, fields, wt)


_FFN_LN = ("wo", "so", "bo", "g", "b", "w1", "s1", "b1", "w2", "s2", "b2")
_CROSS = ("wq", "sq", "bq", "wkv", "skv", "bkv") + _FFN_LN
_SELF = ("wsqkv", "ssqkv", "bsqkv", "wso", "sso", "bso")


def _codes_of(name, x2, codes):
    """``x2 [M, hid]``'s row quantization: ``codes`` (int8 ``[M, hid]``,
    f32 ``[M]``) where the caller has them, else the row quantizer's."""
    if codes is None:
        return quant_rows_cuda(x2)
    q, s = codes
    if (tuple(q.shape) != tuple(x2.shape) or q.dtype != torch.int8
            or tuple(s.shape) != (x2.shape[0],) or s.dtype != torch.float32
            or not (q.is_contiguous() and s.is_contiguous())
            or q.device != x2.device or s.device != x2.device):
        raise ValueError(f"{name}: the codes of an input {tuple(x2.shape)} "
                         f"are contiguous int8 {tuple(x2.shape)} and f32 "
                         f"[{x2.shape[0]}] on {x2.device}; got "
                         f"{tuple(q.shape)} {q.dtype}, {tuple(s.shape)} "
                         f"{s.dtype}")
    return q, s


def _with_codes(out):
    """(out, its row codes ``[n*L, hid]``, scales ``[n*L]``): what a layer
    with ``codes_out`` returns, from :func:`_quant_rows` (the plain path)."""
    q, s = _quant_rows(out)
    return out, q.reshape(-1, out.shape[-1]), s.reshape(-1)


def _ffn_tail(hq, sh, res, p, wt, codes_out):
    """LN(res + heads @ wo) -> LN(. + FFN(.)) on row-major 2-D tensors, the
    heads as their codes: (out, its codes and scales with ``codes_out``,
    else None twice)."""
    y, yq, sy = _gemm_q8_res_ln(hq, sh, p.wo, p.so, p.bo, res, p.g, p.b,
                                quant_out=True, wt=wt["wo"])
    pf = p.w1.shape[1]
    _, mq, sm = _gemm_q8(yq, sy, p.w1, p.s1, p.b1, relu=True, wt=wt["w1"],
                         seg=pf, n_seg=1, t_out=False)
    return _gemm_q8_res_ln(mq, sm[0], p.w2, p.s2, p.b2, y, p.g, p.b,
                           quant_out=codes_out, wt=wt["w2"])


def _self_attention(xq, sx, wqkv, sqkv, bqkv, n, n_heads, wt, dt):
    """Packed QKV projection of the codes ``xq [n*L, hid]`` (``wt``:
    ``wqkv``'s K-major pack; Q and K leave it as codes, V in ``dt``) and
    int8 self-attention -> the heads' codes and scales."""
    hid = xq.shape[1]
    qkv, qk, sqk = _gemm_q8(xq, sx, wqkv, sqkv, bqkv, wt=wt, seg=hid,
                            n_seg=2)
    vt, sv = quant_cols_cuda(qkv[:, 2 * hid:], n)
    _, hq, sh = _attention_q8(qk[:, :hid], sqk[0], qk[:, hid:], sqk[1], vt,
                              sv, n, n_heads, dt)
    return hq, sh


def _cross_tail_cuda(t2, tq, st, eq, se, p, n, n_heads, wt, codes_out):
    """The cross tail on ``t2 [n*Lq, hid]`` and the encoder output's codes
    ``eq [n*Lk, hid]``, ``tq, st``: t2's codes."""
    hid = t2.shape[1]
    _, qq, sq = _gemm_q8(tq, st, p.wq, p.sq, p.bq, wt=wt["wq"], seg=hid,
                         n_seg=1, t_out=False)
    kv, kq, sk = _gemm_q8(eq, se, p.wkv, p.skv, p.bkv, wt=wt["wkv"],
                          seg=hid, n_seg=1)
    vt, sv = quant_cols_cuda(kv[:, hid:], n)
    _, hq, sh = _attention_q8(qq, sq[0], kq, sk[0], vt, sv, n, n_heads,
                              t2.dtype)
    return _ffn_tail(hq, sh, t2, p, wt, codes_out)


def _encoder_layer_q8_cuda(name, x, p, n_heads, wt, x_codes, codes_out):
    n, l, hid = x.shape
    wt = _check_kernel_args(name, [("x", x)], p, ("wqkv", "sqkv", "bqkv")
                            + _FFN_LN, n_heads, l, wt)
    x2 = x.view(n * l, hid)
    xq, sx = _codes_of(name, x2, x_codes)
    hq, sh = _self_attention(xq, sx, p.wqkv, p.sqkv, p.bqkv, n, n_heads,
                             wt["wqkv"], x.dtype)
    out, q, s = _ffn_tail(hq, sh, x2, p, wt, codes_out)
    out = out.view(n, l, hid)
    return (out, q, s) if codes_out else out


def encoder_layer_q8(x, p: Q8EncoderLayerParams, n_heads: int, wt=None, *,
                     x_codes=None, codes_out: bool = False):
    """int8 self-attention layer: ``x [n, L, hid] -> [n, L, hid]``. ``wt``:
    :func:`pack_wt` of ``p``, which the kernels need on the card.
    ``x_codes``: x's row quantization (int8 ``[n*L, hid]``, f32 ``[n*L]``)
    where the caller has it (a layer's ``codes_out``), so the layer
    quantizes nothing itself; with ``codes_out`` the layer returns (out,
    its codes, their scales) (on the CPU, :func:`_quant_rows` of the
    output)."""
    if x.device.type == "cpu":
        out = encoder_layer_q8_plain(x, p, n_heads)
        return _with_codes(out) if codes_out else out
    with torch.cuda.device(x.device):
        out = _encoder_layer_q8_cuda("encoder_layer_q8", x, p, n_heads, wt,
                                     x_codes, codes_out)
    kernels.launches["encoder_layer_q8"] += 1
    return out


def encoder_layer_with_stem_q8(spec_t, keff, beff, pos,
                               p: Q8EncoderLayerParams, n_heads: int,
                               n_frame: int, out_dtype, wt=None, *,
                               codes_out: bool = False):
    """The f32 stem + position embedding (K2's stem kernel), then the int8
    first encoder layer. The kernels take ``out_dtype`` bfloat16 or
    float32 (``wt`` and ``codes_out`` as for :func:`encoder_layer_q8`)."""
    if spec_t.device.type == "cpu":
        out = encoder_layer_with_stem_q8_plain(spec_t, keff, beff, pos, p,
                                               n_heads, n_frame, out_dtype)
        return _with_codes(out) if codes_out else out
    kernels.check_dtype("encoder_layer_with_stem_q8", out_dtype)
    with torch.cuda.device(spec_t.device):
        x = lf._stem_embed(spec_t, keff, beff, pos, n_frame, out_dtype)
        out = _encoder_layer_q8_cuda("encoder_layer_with_stem_q8", x, p,
                                     n_heads, wt, None, codes_out)
    kernels.launches["encoder_layer_with_stem_q8"] += 1
    return out


def decoder_layer_zero_q8(trg, enc, p: Q8CrossLayerParams, n_heads: int,
                          wt=None, *, trg_codes=None, enc_codes=None,
                          codes_out: bool = False):
    """int8 cross-attention-only decoder layer (the cross fields of ``p``,
    ``list(p)[6:]``; ``wt`` and ``codes_out`` as for
    :func:`encoder_layer_q8`; ``trg_codes`` / ``enc_codes``: the inputs'
    row quantizations, as ``x_codes`` there)."""
    if trg.device.type == "cpu":
        out = decoder_layer_zero_q8_plain(trg, enc, p, n_heads)
        return _with_codes(out) if codes_out else out
    n, lq, hid = trg.shape
    name = "decoder_layer_zero_q8"
    wt = _check_kernel_args(name, [("trg", trg), ("enc", enc)], p, _CROSS,
                            n_heads, enc.shape[1], wt)
    with torch.cuda.device(trg.device):
        t2, e2 = trg.view(n * lq, hid), enc.view(-1, hid)
        tq, st = _codes_of(name, t2, trg_codes)
        eq, se = _codes_of(name, e2, enc_codes)
        out, q, s = _cross_tail_cuda(t2, tq, st, eq, se, p, n, n_heads, wt,
                                     codes_out)
    kernels.launches[name] += 1
    out = out.view(n, lq, hid)
    return (out, q, s) if codes_out else out


def decoder_layer_q8(trg, enc, p: Q8CrossLayerParams, n_heads: int,
                     wt=None, *, trg_codes=None, enc_codes=None,
                     codes_out: bool = False):
    """int8 self + cross decoder layer (the keywords as for
    :func:`decoder_layer_zero_q8`)."""
    if trg.device.type == "cpu":
        out = decoder_layer_q8_plain(trg, enc, p, n_heads)
        return _with_codes(out) if codes_out else out
    n, lq, hid = trg.shape
    name = "decoder_layer_q8"
    wt = _check_kernel_args(name, [("trg", trg), ("enc", enc)], p,
                            _SELF + _CROSS, n_heads, (lq, enc.shape[1]),
                            wt)
    with torch.cuda.device(trg.device):
        t2, e2 = trg.view(n * lq, hid), enc.view(-1, hid)
        tq, st = _codes_of(name, t2, trg_codes)
        hq, sh = _self_attention(tq, st, p.wsqkv, p.ssqkv, p.bsqkv, n,
                                 n_heads, wt["wsqkv"], trg.dtype)
        # the prologue's LayerNorm epilogue hands the cross tail its input
        # already quantized
        t2, tq, st = _gemm_q8_res_ln(hq, sh, p.wso, p.sso, p.bso, t2, p.g,
                                     p.b, quant_out=True, wt=wt["wso"])
        eq, se = _codes_of(name, e2, enc_codes)
        out, q, s = _cross_tail_cuda(t2, tq, st, eq, se, p, n, n_heads, wt,
                                     codes_out)
    kernels.launches[name] += 1
    out = out.view(n, lq, hid)
    return (out, q, s) if codes_out else out
