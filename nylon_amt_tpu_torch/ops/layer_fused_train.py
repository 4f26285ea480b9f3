"""Training layers K7, K8 and K9 with their analytic backward, and their
plain versions.

Port of :mod:`nylon_amt_tpu.ops.layer_fused_train`:

* :func:`encoder_layer_train` (K7): post-LN self-attention block with
  dropout on the attention probabilities (per head), the attention output,
  the FFN hidden and the FFN output, and with ``emb_drop`` also on the
  layer's input (the first layer of each stage);
* :func:`decoder_layer_zero_train` (K8): cross-attention + FFN block; its
  backward also gives the gradient of the encoder stream;
* :func:`decoder_layer_train` (K9): self-attention over the note queries
  (sites SA, SA_OUT), then K8's tail.

Each is a :class:`torch.autograd.Function` whose forward saves only its
inputs, the weights and the dropout seed, as the JAX custom VJPs do; its
backward recomputes the forward internals and runs the analytic backward.
Dropout masks are the index hashes of K6 (:mod:`.attention`), so the
backward regenerates the forward's masks exactly.

On a CPU tensor both directions run the plain versions: the JAX kernels'
bodies (``_enc_train_fwd_body``, ``_enc_train_bwd_kernel``,
``_cross_tail_fwd_body``, ``_cross_tail_bwd_body``,
``_self_prologue_fwd``, ``_dec_train_bwd_kernel``) transcribed op for op,
with the same bf16 cast points and f32 weight gradients. On a CUDA device
they launch the hand-written kernels of ``csrc/layer_fused.cu`` (forward,
with a dropout site), ``csrc/layer_fused_train.cu`` (backward) and
``csrc/mha.cu`` (the attention step of both) for bfloat16 activations, or
their float32 twins (``csrc/layer_fused_f32.cu``, ``csrc/mha_f32.cu`` and
the f32 instantiation of the LayerNorm backward) for float32 ones, the
default model configuration's compute dtype; any other dtype raises.
The plain backward bodies take their matrix products from
:func:`gemm_nt_plain` and :func:`weight_grad_plain`, the plain twins of the
backward's dX and dW kernels alone (``chip_smoke.py`` (p) holds the bf16
kernels to them, (r) the float32 ones); ``check_gemm_nt`` and
``check_wgrad`` refuse, before the library loads, the shapes those kernels
do not take, and ``wgrad_plan`` splits the rows of a dW product into the
kernel's chunks.

Weights arrive in float32 (so their gradients are float32) and are cast to
the compute dtype (the activations' dtype): the plain versions on use, as
the TPU kernels cast on read; the autograd Functions once per call of the
training step, in the forward, and the backward reuses that copy (for
float32 with the TF32 pairs that the forward and the dX GEMMs read, from
one ``pack_tf32``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import layer_fused as lf
from nylon_amt_tpu_torch.ops.attention import (
    _mm,
    apply_keep_mask,
    hash_keep_mask_plain,
    mha_bwd_plain,
    mha_plain,
    seed_mix,
    site_constants,
    site_key,
)
from nylon_amt_tpu_torch.ops.layer_fused import (
    _LN_EPS,
    _LOG2E,
    EncoderLayerParams,
    _matmul,
    _scale,
)
from nylon_amt_tpu_torch.ops.precision import full_f32

# Dropout site tags (the JAX kernels' ``_SITE_*``); the attention-weight
# sites use ``_head_tag(tag_base, head)`` per head.
_SITE_ATTN, _SITE_ATTN_OUT, _SITE_FFN_MID, _SITE_FFN_OUT = 0, 1, 2, 3
_SITE_SA, _SITE_SA_OUT = 4, 5
_SITE_EMB = 6


def _head_tag(tag_base: int, head: int) -> int:
    return (tag_base + 8) * 64 + head


class DecZeroParams(NamedTuple):
    """Cross-attention-only decoder block weights (f32), training path."""

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


class DecLayerParams(NamedTuple):
    """Self+cross decoder block weights (f32), training path."""

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


# ----------------------------------------------------------- plain versions --

def _drop_fn(seed: int, rate: float, device):
    """``drop(tag, shape, dtype)`` -> the site's keep mask (plain)."""
    return lambda tag, shape, dtype=torch.float32: hash_keep_mask_plain(
        seed, tag, 0, shape, rate, dtype, device)


def _ln_fwd(x, g, b):
    """Returns (y, xhat, inv); statistics in f32 (two-pass)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + _LN_EPS)
    xhat = (xf - mu) * inv
    return (xhat * g + b).to(x.dtype), xhat, inv


def _ln_bwd(dy, xhat, inv, g):
    """dy -> (dx, dgamma, dbeta); all f32, reductions over the last axis."""
    dyf = dy.float()
    lead = tuple(range(dy.dim() - 1))
    dgamma = (dyf * xhat).sum(lead)
    dbeta = dyf.sum(lead)
    dxhat = dyf * g
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * inv, dgamma, dbeta


def _flat(t):
    return t.reshape(-1, t.shape[-1])


def ln_bwd_plain(dy, s, g, site=None):
    """The plain twin of the LayerNorm backward kernel
    (``csrc/layer_fused_train.cu`` ``ln_bwd_kernel``, ``nylon_ln_bwd``) on
    ``dy`` and the pre-LN sum ``s [M, N]`` of dtype ``dt`` and ``g [N]``:
    xhat and inv recomputed from ``s`` as :func:`_ln_fwd` does, then
    :func:`_ln_bwd`. Returns ``(da, dam, dgamma, dbeta)``: da = dt(dx); dam
    = dt(da x keep) of the dropout site ``site`` (a ``_Site``), None
    without one; the sums in f32."""
    gf = g.float()
    _, xhat, inv = _ln_fwd(s, gf, torch.zeros_like(gf))
    dx, dg, db = _ln_bwd(dy, xhat, inv, gf)
    da = dx.to(dy.dtype)
    dam = None if site is None else (da * _keep(site, da)).to(dy.dtype)
    return da, dam, dg, db


def _keep(m, like):
    """A keep mask given as values (a tensor) or as a kernel's dropout site
    (``_Site``), as values shaped like ``like``."""
    return m if torch.is_tensor(m) else lf._site_mask(m, like)


def gemm_nt_plain(dy, w, gate=None, addend=None, m1=None, m2=None):
    """The plain twin of the dX GEMM kernel (``csrc/layer_fused_train.cu``
    ``gemm_nt_kernel``, ``nylon_gemm_nt``): ``v = dt(dy @ w^T)`` on ``dy
    [.., N]`` of dtype ``dt`` and ``w [Kout, N]``, then ``v = dt(v x m1)``,
    ``v = 0`` where not ``gate > 0`` (the forward's ReLU), ``v = dt(addend
    + v)``, ``v = dt(v x m2)``, each step where its argument is given.
    ``m1`` / ``m2``: keep masks (values shaped like the output) or the
    kernel's dropout sites (``_Site``)."""
    with full_f32():
        v = _mm(dy, w.t()).to(dy.dtype)
    if m1 is not None:
        v = v * _keep(m1, v)
    if gate is not None:
        v = torch.where(gate.float() > 0, v, torch.zeros_like(v))
    if addend is not None:
        v = addend + v
    if m2 is not None:
        v = v * _keep(m2, v)
    return v


def weight_grad_plain(a, dy):
    """The plain twin of the dW GEMM kernel (``wgrad_kernel`` and
    ``reduce_rows_kernel``, ``nylon_wgrad``): ``(a^T dy, column sums of dy)``
    over every row of ``a [.., Ka]`` and ``dy [.., N]``, both f32."""
    with full_f32():
        dw = _mm(_flat(a).t(), _flat(dy))
    return dw, dy.float().sum(tuple(range(dy.dim() - 1)))


def _head_masks(active, drop, tag_base):
    """Head h's keep mask of a layer's probability site (None at rate 0)."""
    if not active:
        return None
    return lambda h, shape: drop(_head_tag(tag_base, h), shape)


def _heads_fwd_cross(q, kv, n_heads, scale, active, drop,
                     tag_base=_SITE_ATTN):
    """Per-head attention, dropout on the normalised weights (``l`` from the
    unmasked ``p``). ``q [n, Lq, hid]``, ``kv [n, Lk, 2 hid]``."""
    hid = q.shape[-1]
    return mha_plain(q, kv[..., :hid], kv[..., hid:], n_heads, scale,
                     _head_masks(active, drop, tag_base))


def _heads_fwd(qkv, n_heads, scale, active, drop, tag_base=_SITE_ATTN):
    hid = qkv.shape[-1] // 3
    return _heads_fwd_cross(qkv[..., :hid], qkv[..., hid:], n_heads, scale,
                            active, drop, tag_base)


def _heads_bwd_cross(q, kv, do, n_heads, scale, active, drop,
                     tag_base=_SITE_ATTN):
    """Attention backward with regenerated masks; returns ``(dq, dkv)``."""
    hid = q.shape[-1]
    dq, dk, dv = mha_bwd_plain(q, kv[..., :hid], kv[..., hid:], do, n_heads,
                               scale, _head_masks(active, drop, tag_base))
    return dq, torch.cat([dk, dv], dim=-1)


def _heads_bwd(qkv, do, n_heads, scale, active, drop, tag_base=_SITE_ATTN):
    hid = qkv.shape[-1] // 3
    dq, dkv = _heads_bwd_cross(qkv[..., :hid], qkv[..., hid:], do, n_heads,
                               scale, active, drop, tag_base)
    return torch.cat([dq, dkv], dim=-1)


def _enc_fwd_body(x, p, seed, n_heads, rate, emb_drop):
    dt = x.dtype
    c = lambda w: w.to(dt)
    active = rate > 0.0
    scale = _scale(x.shape[-1], n_heads)
    drop = _drop_fn(seed, rate, x.device)
    if active and emb_drop:
        x = x * drop(_SITE_EMB, tuple(x.shape), dt)
    qkv = _matmul(x, c(p.wqkv), c(p.bqkv))
    heads = _heads_fwd(qkv, n_heads, scale, active, drop)
    attn = _matmul(heads, c(p.wo), c(p.bo))
    if active:
        attn = attn * drop(_SITE_ATTN_OUT, tuple(attn.shape), dt)
    y, _, _ = _ln_fwd(x + attn, p.g, p.b)
    mid = torch.relu(_matmul(y, c(p.w1), c(p.b1)))
    if active:
        mid = mid * drop(_SITE_FFN_MID, tuple(mid.shape), dt)
    ff = _matmul(mid, c(p.w2), c(p.b2))
    if active:
        ff = ff * drop(_SITE_FFN_OUT, tuple(ff.shape), dt)
    z, _, _ = _ln_fwd(y + ff, p.g, p.b)
    return z


def _tap(taps, scope, prefix=""):
    """Record the tensors of a body's ``scope`` (its locals) in ``taps``,
    named ``prefix + local name``."""
    if taps is not None:
        taps.update({prefix + k: v for k, v in scope.items()
                     if torch.is_tensor(v)})


def _enc_bwd_body(x, p, seed, dz, n_heads, rate, emb_drop, taps=None):
    dt = x.dtype
    c = lambda w: w.to(dt)
    active = rate > 0.0
    scale = _scale(x.shape[-1], n_heads)
    drop = _drop_fn(seed, rate, x.device)
    if active and emb_drop:
        # the layer (recompute AND dwqkv/dx) sees x * m0; the gradient of
        # the raw x takes the same mask on the way out
        m0 = drop(_SITE_EMB, tuple(x.shape), dt)
        x = x * m0

    # ---- recompute forward (masks identical by construction) ----
    qkv = _matmul(x, c(p.wqkv), c(p.bqkv))
    heads = _heads_fwd(qkv, n_heads, scale, active, drop)
    attn_pre = _matmul(heads, c(p.wo), c(p.bo))
    if active:
        m2 = drop(_SITE_ATTN_OUT, tuple(attn_pre.shape), dt)
        attn = attn_pre * m2
    else:
        attn = attn_pre
    a1 = x + attn
    y, xhat1, inv1 = _ln_fwd(a1, p.g, p.b)
    u = _matmul(y, c(p.w1), c(p.b1))
    mid = torch.relu(u)
    if active:
        m3 = drop(_SITE_FFN_MID, tuple(mid.shape), dt)
        midd = mid * m3
    else:
        midd = mid
    ff_pre = _matmul(midd, c(p.w2), c(p.b2))
    if active:
        m4 = drop(_SITE_FFN_OUT, tuple(ff_pre.shape), dt)
        ff = ff_pre * m4
    else:
        ff = ff_pre
    a2 = y + ff
    _, xhat2, inv2 = _ln_fwd(a2, p.g, p.b)

    # ---- backward ----
    gf = p.g.float()
    da2, dg2, db2_ = _ln_bwd(dz, xhat2, inv2, gf)
    da2 = da2.to(dt)
    dff = da2 * m4 if active else da2
    dw2, db2 = weight_grad_plain(midd, dff)
    du = gemm_nt_plain(dff, c(p.w2), gate=u, m1=m3 if active else None)
    dw1, db1 = weight_grad_plain(y, du)
    dy = gemm_nt_plain(du, c(p.w1), addend=da2)
    da1, dg1, db1_ = _ln_bwd(dy, xhat1, inv1, gf)
    da1 = da1.to(dt)
    dattn = da1 * m2 if active else da1
    dwo, dbo = weight_grad_plain(heads, dattn)
    dheads = gemm_nt_plain(dattn, c(p.wo))
    dqkv = _heads_bwd(qkv, dheads, n_heads, scale, active, drop)
    dwqkv, dbqkv = weight_grad_plain(x, dqkv)
    dx = gemm_nt_plain(dqkv, c(p.wqkv), addend=da1,
                       m2=m0 if active and emb_drop else None)
    _tap(taps, locals())
    return dx, EncoderLayerParams(dwqkv, dbqkv, dwo, dbo, dg1 + dg2,
                                  db1_ + db2_, dw1, db1, dw2, db2)


def _cross_tail_fwd_body(trg, enc, p, n_heads, scale, active, drop):
    dt = trg.dtype
    c = lambda w: w.to(dt)
    q = _matmul(trg, c(p.wq), c(p.bq))
    kv = _matmul(enc, c(p.wkv), c(p.bkv))
    heads = _heads_fwd_cross(q, kv, n_heads, scale, active, drop)
    attn = _matmul(heads, c(p.wo), c(p.bo))
    if active:
        attn = attn * drop(_SITE_ATTN_OUT, tuple(attn.shape), dt)
    y, _, _ = _ln_fwd(trg + attn, p.g, p.b)
    mid = torch.relu(_matmul(y, c(p.w1), c(p.b1)))
    if active:
        mid = mid * drop(_SITE_FFN_MID, tuple(mid.shape), dt)
    ff = _matmul(mid, c(p.w2), c(p.b2))
    if active:
        ff = ff * drop(_SITE_FFN_OUT, tuple(ff.shape), dt)
    z, _, _ = _ln_fwd(y + ff, p.g, p.b)
    return z


def _self_prologue(trg, p, n_heads, scale, active, drop):
    """Self-attention + shared LN over the queries; returns (t1, recompute
    state for the backward)."""
    dt = trg.dtype
    c = lambda w: w.to(dt)
    qkv = _matmul(trg, c(p.wsqkv), c(p.bsqkv))
    sheads = _heads_fwd(qkv, n_heads, scale, active, drop,
                        tag_base=_SITE_SA)
    sa_pre = _matmul(sheads, c(p.wso), c(p.bso))
    msa = drop(_SITE_SA_OUT, tuple(sa_pre.shape), dt) if active else None
    sa = sa_pre * msa if active else sa_pre
    a0 = trg + sa
    t1, xhat0, inv0 = _ln_fwd(a0, p.g, p.b)
    return t1, (qkv, sheads, msa, a0, xhat0, inv0)


def _cross_tail_bwd_body(trg, enc, dz, p, n_heads, scale, active, drop,
                         taps=None):
    """Backward of the cross tail: (dtrg, denc, grads of its 12 fields)."""
    dt = trg.dtype
    c = lambda w: w.to(dt)
    gf = p.g.float()
    q = _matmul(trg, c(p.wq), c(p.bq))
    kv = _matmul(enc, c(p.wkv), c(p.bkv))
    heads = _heads_fwd_cross(q, kv, n_heads, scale, active, drop)
    attn_pre = _matmul(heads, c(p.wo), c(p.bo))
    if active:
        m2 = drop(_SITE_ATTN_OUT, tuple(attn_pre.shape), dt)
        attn = attn_pre * m2
    else:
        attn = attn_pre
    a1 = trg + attn
    y, xhat1, inv1 = _ln_fwd(a1, p.g, p.b)
    u = _matmul(y, c(p.w1), c(p.b1))
    mid = torch.relu(u)
    if active:
        m3 = drop(_SITE_FFN_MID, tuple(mid.shape), dt)
        midd = mid * m3
    else:
        midd = mid
    ff_pre = _matmul(midd, c(p.w2), c(p.b2))
    if active:
        m4 = drop(_SITE_FFN_OUT, tuple(ff_pre.shape), dt)
    a2 = y + (ff_pre * m4 if active else ff_pre)
    _, xhat2, inv2 = _ln_fwd(a2, p.g, p.b)

    da2, dg2, db2_ = _ln_bwd(dz, xhat2, inv2, gf)
    da2 = da2.to(dt)
    dff = da2 * m4 if active else da2
    dw2, db2 = weight_grad_plain(midd, dff)
    du = gemm_nt_plain(dff, c(p.w2), gate=u, m1=m3 if active else None)
    dw1, db1 = weight_grad_plain(y, du)
    dy = gemm_nt_plain(du, c(p.w1), addend=da2)
    da1, dg1, db1_ = _ln_bwd(dy, xhat1, inv1, gf)
    da1 = da1.to(dt)
    dattn = da1 * m2 if active else da1
    dwo, dbo = weight_grad_plain(heads, dattn)
    dheads = gemm_nt_plain(dattn, c(p.wo))
    dq, dkv = _heads_bwd_cross(q, kv, dheads, n_heads, scale, active,
                               drop)
    dwq, dbq = weight_grad_plain(trg, dq)
    dwkv, dbkv = weight_grad_plain(enc, dkv)
    dtrg = gemm_nt_plain(dq, c(p.wq), addend=da1)
    denc = gemm_nt_plain(dkv, c(p.wkv))
    _tap(taps, locals(), "cross.")
    grads = dict(wq=dwq, bq=dbq, wkv=dwkv, bkv=dbkv, wo=dwo, bo=dbo,
                 g=dg1 + dg2, b=db1_ + db2_, w1=dw1, b1=db1, w2=dw2, b2=db2)
    return dtrg, denc, grads


def encoder_layer_train_plain(x, p: EncoderLayerParams, seed: int,
                              n_heads: int, rate: float,
                              emb_drop: bool = False):
    """The training forward of one self-attention block (plain)."""
    with full_f32():
        return _enc_fwd_body(x, p, seed, n_heads, rate, emb_drop)


def encoder_layer_train_bwd_plain(x, p: EncoderLayerParams, seed: int, dz,
                                  n_heads: int, rate: float,
                                  emb_drop: bool = False, taps=None):
    """``(dx, EncoderLayerParams of f32 weight gradients)`` (plain). A dict
    ``taps`` receives the intermediates under the names the kernels' stage
    hook uses (see :func:`encoder_layer_train_bwd_cuda`)."""
    with full_f32():
        return _enc_bwd_body(x, p, seed, dz, n_heads, rate, emb_drop, taps)


def decoder_layer_zero_train_plain(trg, enc, p: DecZeroParams, seed: int,
                                   n_heads: int, rate: float):
    with full_f32():
        return _cross_tail_fwd_body(trg, enc, p, n_heads,
                                    _scale(trg.shape[-1], n_heads), rate > 0,
                                    _drop_fn(seed, rate, trg.device))


def decoder_layer_zero_train_bwd_plain(trg, enc, p: DecZeroParams, seed: int,
                                       dz, n_heads: int, rate: float,
                                       taps=None):
    """``(dtrg, denc, DecZeroParams of f32 weight gradients)`` (plain);
    ``taps`` as for the encoder."""
    with full_f32():
        dtrg, denc, grads = _cross_tail_bwd_body(
            trg, enc, dz, p, n_heads, _scale(trg.shape[-1], n_heads),
            rate > 0, _drop_fn(seed, rate, trg.device), taps)
    return dtrg, denc, DecZeroParams(**grads)


def decoder_layer_train_plain(trg, enc, p: DecLayerParams, seed: int,
                              n_heads: int, rate: float):
    scale = _scale(trg.shape[-1], n_heads)
    drop = _drop_fn(seed, rate, trg.device)
    with full_f32():
        t1, _ = _self_prologue(trg, p, n_heads, scale, rate > 0, drop)
        return _cross_tail_fwd_body(t1, enc, p, n_heads, scale, rate > 0,
                                    drop)


def decoder_layer_train_bwd_plain(trg, enc, p: DecLayerParams, seed: int, dz,
                                  n_heads: int, rate: float, taps=None):
    """``(dtrg, denc, DecLayerParams of f32 weight gradients)`` (plain);
    ``taps`` gets the cross tail's intermediates as ``"cross.<name>"`` and
    the self-attention prologue's as ``"self.<name>"``."""
    dt = trg.dtype
    c = lambda w: w.to(dt)
    scale = _scale(trg.shape[-1], n_heads)
    active = rate > 0
    drop = _drop_fn(seed, rate, trg.device)
    with full_f32():
        t1, (qkv, sheads, msa, a0, xhat0, inv0) = _self_prologue(
            trg, p, n_heads, scale, active, drop)
        dt1, denc, grads = _cross_tail_bwd_body(t1, enc, dz, p, n_heads,
                                                scale, active, drop, taps)
        da0, dg0, db0 = _ln_bwd(dt1, xhat0, inv0, p.g.float())
        da0 = da0.to(dt)
        # shared LN: the prologue's LN adds to the same gamma/beta grads
        grads["g"] = grads["g"] + dg0
        grads["b"] = grads["b"] + db0
        dsa = da0 * msa if active else da0
        dwso, dbso = weight_grad_plain(sheads, dsa)
        dsheads = gemm_nt_plain(dsa, c(p.wso))
        dqkv = _heads_bwd(qkv, dsheads, n_heads, scale, active, drop,
                          tag_base=_SITE_SA)
        dwsqkv, dbsqkv = weight_grad_plain(trg, dqkv)
        dtrg = gemm_nt_plain(dqkv, c(p.wsqkv), addend=da0)
    _tap(taps, locals(), "self.")
    return dtrg, denc, DecLayerParams(wsqkv=dwsqkv, bsqkv=dbsqkv, wso=dwso,
                                      bso=dbso, **grads)


# ---------------------------------------------------------------- kernels --

class _Site(NamedTuple):
    """A dropout site as the kernels take it (see ``csrc/hash_mask.cuh``)."""

    key: int
    thresh: int
    scale: float
    half: int


_NO_SITE = _Site(0, 0, 0.0, 0)


def _site(seed: int, tag: int, d2: int, rate: float,
          dtype: torch.dtype) -> _Site | None:
    """The site's constants (the keep value rounded to the compute dtype),
    or None at rate 0 (no mask)."""
    if rate <= 0.0:
        return None
    thresh, keep, half = site_constants(rate, d2, dtype)
    return _Site(site_key(seed, tag), thresh, keep, half)


def _gemm_bias(a, w, bias, relu=False, site=None, pair=None):
    """``dt(a @ w) + bias`` [, ReLU] [, x keep mask] (float32: ``pair`` is
    ``tf32_pair(w)``)."""
    if site is None:
        return lf._gemm(a, w, bias, relu, pair)
    (m, k), n = a.shape, w.shape[1]
    lf.check_gemm("gemm_bias", m, k, n, a.dtype)
    wk = lf.gemm_weight("gemm_bias", w, pair, a.dtype)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    kernels.call(kernels.entry("nylon_gemm_bias_drop", a.dtype),
                 a.data_ptr(), *wk, bias.data_ptr(), out.data_ptr(), m, n, k,
                 int(relu), *site, kernels.stream_of(a))
    lf.count_f32_gemm("gemm_bias", a.dtype)
    return out


def _gemm_res_ln(a, w, bias, res, g, b, site=None, pre=False, out=True,
                 pair=None):
    """``LN(res + (dt(a @ w) + bias) [x keep])``; returns ``(out or None,
    pre-LN sum or None)`` (float32: ``pair`` is ``tf32_pair(w)``)."""
    if site is None and not pre:
        return lf._gemm_res_ln(a, w, bias, res, g, b, pair), None
    (m, k), n = a.shape, w.shape[1]
    lf.check_gemm("gemm_res_ln", m, k, n, a.dtype, ln=True)
    wk = lf.gemm_weight("gemm_res_ln", w, pair, a.dtype)
    y = torch.empty((m, n), dtype=a.dtype, device=a.device) if out else None
    s = torch.empty((m, n), dtype=a.dtype, device=a.device) if pre else None
    kernels.call(kernels.entry("nylon_gemm_res_ln_train", a.dtype),
                 a.data_ptr(), *wk, bias.data_ptr(), res.data_ptr(),
                 g.data_ptr(), b.data_ptr(),
                 None if y is None else y.data_ptr(),
                 None if s is None else s.data_ptr(), m, n, k, _LN_EPS,
                 int(site is not None), *(site or _NO_SITE),
                 kernels.stream_of(a))
    lf.count_f32_gemm("gemm_res_ln", a.dtype)
    return y, s


def _attention(q, k, v, n, n_heads, seed, rate, tag_base,
               ffma_scores=False):
    """Attention of ``n`` sequences on strided 2-D views, with dropout on
    the probabilities of each head at rate > 0 (``ffma_scores``: float32
    with the scores on FFMA, for the layer that the stem feeds)."""
    drop = None
    if rate > 0.0:
        thresh, keep, half = site_constants(rate, k.shape[0] // n,
                                            torch.float32)
        drop = (seed_mix(seed), _head_tag(tag_base, 0), thresh, keep, half)
    return lf._attention(q, k, v, n, n_heads, ffma_scores, drop)


def _attention_bwd(q, k, v, do, dq, dk, dv, n, n_heads, seed, rate,
                   tag_base, ffma_scores=False):
    """dq, dk, dv (written into the given strided views) of attention
    (``ffma_scores``: float32 with the scores recomputed on FFMA as the
    forward computes them, for the layer that the stem feeds)."""
    hid = q.shape[1]
    lq, lk = q.shape[0] // n, k.shape[0] // n
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("dq", dq),
                    ("dk", dk), ("dv", dv)):
        lf.check_rows(f"attention backward: {name}", t)
    if k.stride(0) != v.stride(0) or dk.stride(0) != dv.stride(0):
        raise ValueError("attention backward: k/v and dk/dv must share "
                         "their row strides")
    active = rate > 0.0
    thresh, keep, half = (site_constants(rate, lk, torch.float32) if active
                          else (0, 0.0, 0))
    scale = _scale(hid, n_heads)
    name = ("nylon_attention_bwd_ffma_f32"
            if ffma_scores and q.dtype == torch.float32
            else kernels.entry("nylon_attention_bwd", q.dtype))
    kernels.call(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 n, lq, lk, n_heads, hid // n_heads, q.stride(0),
                 k.stride(0), do.stride(0),
                 dq.stride(0), dk.stride(0), scale, scale * _LOG2E,
                 int(active), seed_mix(seed), _head_tag(tag_base, 0), thresh,
                 keep, half, kernels.stream_of(q))


# ln_bwd_kernel's consumer warps and widest row (csrc/layer_fused_train.cu
# kLnWarps, kLnMaxN)
_LN_WARPS, _LN_MAX_N = 15, 256


def ln_bwd_layout(n: int, dtype) -> tuple[int, int, int]:
    """``(kc, lanes, rows)`` of the LayerNorm backward kernel at row width
    ``n`` (``csrc/layer_fused_train.cu::ln_layout``): 16-byte chunks a lane,
    lanes a row (a power of two up to 32, the fewest with no lane idle;
    where no ``kc <= 3`` gives that, 32 with the chunks past the row idle)
    and rows a tile (one row group of each consumer warp)."""
    chunks = n * dtype.itemsize // 16
    for kc in (1, 2, 3):
        lanes = chunks // kc
        if chunks % kc == 0 and lanes <= 32 and lanes & (lanes - 1) == 0:
            return kc, lanes, _LN_WARPS * 32 // lanes
    return -(-chunks // 32), 32, _LN_WARPS


def ln_bwd_plan(m: int, n: int, dtype, sms: int) -> tuple[int, int]:
    """``(rows a tile, blocks)`` of the LayerNorm backward kernel over ``m``
    rows: a persistent grid of two blocks an SM where a lane holds one
    chunk, else one (the kernel's ``kLnBlocks``), at most one a tile
    (block b takes the tiles b, b + blocks, ..)."""
    kc, _, rows = ln_bwd_layout(n, dtype)
    return rows, min((2 if kc == 1 else 1) * sms, -(-m // rows))


def check_ln_bwd(name: str, dy, s) -> None:
    """Raise ``ValueError`` unless the LayerNorm backward kernel takes ``dy``
    and the pre-LN sum ``s``: bfloat16 or float32 ``[M, N]`` of one dtype
    and shape, N a multiple of 32 up to 256, contiguous rows (TMA reads
    row tiles of both) from a 16-byte aligned start."""
    kernels.check_dtype(name, dy.dtype)
    if (dy.dim() != 2 or s.shape != dy.shape or s.dtype != dy.dtype
            or dy.shape[0] <= 0 or dy.shape[1] % 32
            or not 0 < dy.shape[1] <= _LN_MAX_N):
        raise ValueError(f"{name}: the kernel takes dy and s [M, N] of one "
                         f"dtype with N % 32 == 0 and N <= {_LN_MAX_N}; got "
                         f"{tuple(dy.shape)} {dy.dtype} and "
                         f"{tuple(s.shape)} {s.dtype}")
    for what, t in (("dy", dy), ("s", s)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous from a "
                             f"16-byte aligned start")


class _LnGrads:
    """Partial sums of dgamma/dbeta of the shared LayerNorm: ``slots`` LN
    backward passes over the same ``m`` rows write disjoint blocks of
    rows (one a kernel block: ``ln_bwd_plan``), one reduction sums all."""

    def __init__(self, m: int, n: int, slots: int, device, dtype):
        self.rows, self.blocks = ln_bwd_plan(m, n, dtype,
                                             _sm_count(device.index))
        self.parts = torch.empty((2, slots * self.blocks, n),
                                 dtype=torch.float32, device=device)
        self.used = 0

    def slot(self):
        lo = self.used * self.blocks
        self.used += 1
        return (self.parts[0, lo:lo + self.blocks],
                self.parts[1, lo:lo + self.blocks])

    def reduce(self):
        return _reduce(self.parts[0]), _reduce(self.parts[1])


def _reduce(parts):
    """Sum of the rows of ``parts [P, *]`` in row order (f32)."""
    out = torch.empty(parts.shape[1:], dtype=torch.float32,
                      device=parts.device)
    kernels.call("nylon_reduce_rows", parts.data_ptr(), out.data_ptr(),
                 parts.shape[0], out.numel(), kernels.stream_of(parts))
    return out


def _ln_backward(dy, s, g, site, ln: _LnGrads):
    """(da, da x keep) of the LayerNorm whose pre-LN sum was ``s``."""
    check_ln_bwd("ln_backward", dy, s)
    m, n = dy.shape
    da = torch.empty_like(dy)
    dam = torch.empty_like(dy) if site is not None else da
    dg, db = ln.slot()
    kernels.call(kernels.entry("nylon_ln_bwd", dy.dtype), dy.data_ptr(),
                 s.data_ptr(), g.data_ptr(), da.data_ptr(), dam.data_ptr(),
                 dg.data_ptr(), db.data_ptr(),
                 m, n, ln.rows, ln.blocks, _LN_EPS, int(site is not None),
                 *(site or _NO_SITE), kernels.stream_of(dy))
    kernels.launches["ln_bwd"] += 1
    return da, dam


def ln_bwd_cuda(dy, s, g, site=None):
    """The LayerNorm backward kernel alone on CUDA ``dy`` and ``s`` (its
    wiring in the training backward, with one slot of partial sums):
    ``(da, dam or None, dgamma, dbeta)`` as :func:`ln_bwd_plain` gives
    them. ``g``: f32 ``[N]`` on the same device."""
    check_ln_bwd("ln_bwd", dy, s)
    kernels.check_cuda("ln_bwd: dy", dy, dy.dtype, ndim=2)
    if g.dtype != torch.float32 or tuple(g.shape) != (dy.shape[1],) \
            or g.device != dy.device or not g.is_contiguous():
        raise ValueError(f"ln_bwd: gamma must be contiguous float32 "
                         f"[{dy.shape[1]}] on {dy.device}")
    with torch.cuda.device(dy.device):
        ln = _LnGrads(dy.shape[0], dy.shape[1], 1, dy.device, dy.dtype)
        da, dam = _ln_backward(dy, s, g, site, ln)
        dg, db = ln.reduce()
    return da, None if site is None else dam, dg, db


# What the dX and dW entry points take, by activation dtype: the multiple
# of N and Kout (dX) and of Ka and N (dW). bf16 (csrc/layer_fused_train.cu,
# TMA: 16-byte rows) 8; f32 (csrc/layer_fused_f32.cu) 4.
_BWD_MULTIPLE = {torch.bfloat16: 8, torch.float32: 4}


def check_gemm_nt(name: str, m: int, n: int, kout: int, dtype, gate=None,
                  addend=None, m1=None, m2=None) -> None:
    """Raise ``ValueError`` unless the dX kernel takes ``dy [m, n] @ w
    [kout, n]^T`` in ``dtype`` with these side inputs (``[m, kout]``) and
    dropout sites (the kernels take one of gate and addend and one of m1
    and m2 at a time, as every call of the backward gives them): what the C
    entry point would refuse, refused before the library is loaded."""
    kernels.check_dtype(name, dtype)
    k = _BWD_MULTIPLE[dtype]
    if m <= 0 or n <= 0 or kout <= 0 or n % k or kout % k:
        raise ValueError(f"{name}: the {dtype} dX kernel takes N % {k} == 0 "
                         f"and Kout % {k} == 0; got M {m}, N {n}, Kout {kout}")
    for side, t in (("gate", gate), ("addend", addend)):
        if t is not None and tuple(t.shape) != (m, kout):
            raise ValueError(f"{name}: {side} has shape {tuple(t.shape)}, "
                             f"expected {(m, kout)}")
    if gate is not None and addend is not None:
        raise ValueError(f"{name}: the {dtype} dX kernel takes a gate or an "
                         "addend, not both")
    if m1 is not None and m2 is not None:
        raise ValueError(f"{name}: the {dtype} dX kernel takes the dropout "
                         "site m1 or m2, not both")


def _gemm_nt(dy, w, gate=None, addend=None, m1=None, m2=None, pair=None):
    """``dt(dy @ w^T)`` [x m1] [ReLU gate] [+ addend] [x m2] (float32:
    ``pair`` is the dX pair of ``w``, ``tf32_pair(w, nt=True)``)."""
    m, n = dy.shape
    kout = w.shape[0]
    check_gemm_nt("gemm_nt", m, n, kout, dy.dtype, gate, addend, m1, m2)
    wk = lf.gemm_weight("gemm_nt", w, pair, dy.dtype, nt=True)
    out = torch.empty((m, kout), dtype=dy.dtype, device=dy.device)
    kernels.call(kernels.entry("nylon_gemm_nt", dy.dtype), dy.data_ptr(),
                 *wk, out.data_ptr(),
                 None if gate is None else gate.data_ptr(),
                 None if addend is None else addend.data_ptr(), m, n, kout,
                 int(m1 is not None), *(m1 or _NO_SITE),
                 int(m2 is not None), *(m2 or _NO_SITE),
                 kernels.stream_of(dy))
    if dy.dtype == torch.float32:
        kernels.launches["gemm_nt_f32"] += 1
    return out


def wgrad_plan(m: int, tiles: int, sms: int,
               rows_multiple: int = 64) -> tuple[int, int]:
    """``(rows_per_chunk, chunks)`` of the dW kernels over ``m`` rows with
    ``tiles`` output tiles on a card of ``sms`` SMs: one wave of one block
    an SM (tiles x chunks <= sms where tiles allow), every chunk a multiple
    of ``rows_multiple`` rows (the kernel's k-block: 64 in bf16, 32 in
    float32; no TMA box straddles two chunks) holding at least one row,
    every row in exactly one chunk."""
    chunks = max(1, sms // tiles)
    rows = -(-(-(-m // chunks)) // rows_multiple) * rows_multiple
    return rows, -(-m // rows)


def wgrad_tile(ka: int, n: int, dtype) -> tuple[int, int]:
    """The dW kernel's tile of ``dW [ka, n]``: 128 x 128 in bf16; in
    float32 64 rows where ``ka`` is at most 64, else 128, and 64 columns
    where ``n`` is at most 64, else 128. The one rule: ``nylon_wgrad_f32``
    takes the tile as arguments and refuses any other."""
    if dtype == torch.bfloat16:
        return 128, 128
    return (64 if ka <= 64 else 128), (64 if n <= 64 else 128)


def wgrad_layout(m: int, ka: int, n: int, dtype,
                 sms: int) -> tuple[int, int, int, int]:
    """``(bm, bn, rows_per_chunk, chunks)`` of the dW kernel of ``a [m,
    ka]^T @ dy [m, n]`` in ``dtype`` on a card of ``sms`` SMs: the tile
    (``wgrad_tile``) and the row chunks over its tiles (``wgrad_plan``;
    the k-block is 64 rows in bf16, 32 in float32). The bias sums take
    ``chunks * ceil(ka / bm)`` rows."""
    bm, bn = wgrad_tile(ka, n, dtype)
    rows, chunks = wgrad_plan(m, -(-ka // bm) * -(-n // bn), sms,
                              64 if dtype == torch.bfloat16 else 32)
    return bm, bn, rows, chunks


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_wgrad(name: str, m: int, ka: int, n: int, dtype) -> None:
    """Raise ``ValueError`` unless the dW kernel takes ``a [m, ka]^T @ dy
    [m, n]`` in ``dtype``, before the library is loaded."""
    kernels.check_dtype(name, dtype)
    k = _BWD_MULTIPLE[dtype]
    if m <= 0 or ka <= 0 or n <= 0 or ka % k or n % k:
        raise ValueError(f"{name}: the {dtype} dW kernel takes Ka % {k} == 0 "
                         f"and N % {k} == 0; got M {m}, Ka {ka}, N {n}")


def _weight_grad(a, dy):
    """(a^T dy, column sums of dy) in f32: per-chunk partials over row
    chunks (one wave of dW tiles x chunks), then a reduction in chunk
    order; a chunk's column sums of dy come in a part from each of the
    ceil(ka / tile rows) tiles of a column range."""
    m, ka = a.shape
    n = dy.shape[1]
    check_wgrad("weight_grad", m, ka, n, a.dtype)
    bm, bn, rows, chunks = wgrad_layout(m, ka, n, a.dtype,
                                        _sm_count(a.device.index))
    f32 = a.dtype == torch.float32
    part = torch.empty((chunks, ka, n), dtype=torch.float32, device=a.device)
    bias_part = torch.empty((chunks * -(-ka // bm), n), dtype=torch.float32,
                            device=a.device)
    kernels.call(kernels.entry("nylon_wgrad", a.dtype), a.data_ptr(),
                 dy.data_ptr(), part.data_ptr(),
                 bias_part.data_ptr(), m, ka, n, rows, chunks,
                 *((bm, bn) if f32 else ()), kernels.stream_of(a))
    if f32:
        kernels.launches["wgrad_f32"] += 1
    return _reduce(part.view(chunks, -1)).view(ka, n), _reduce(bias_part)


def _check(name, acts, p, n_heads, max_len):
    """Raise unless the kernels take these activations (bfloat16 or
    float32, all of one dtype) and weights."""
    kernels.check_dtype(name, acts[0][1].dtype)
    for act_name, t in acts:
        kernels.check_cuda(f"{name}: {act_name}", t, acts[0][1].dtype, ndim=3)
    n, _, hid = acts[0][1].shape
    if any(t.shape[0] != n or t.shape[2] != hid for _, t in acts):
        raise ValueError(f"{name}: activations disagree on n or hid: "
                         f"{[tuple(t.shape) for _, t in acts]}")
    pf = p.w1.shape[1]
    lf.check_geometry(name, hid, n_heads, max_len, max_len, pf)
    shapes = lf.weight_shapes(hid, pf)
    for f, t in zip(p._fields, p):
        if t.device != acts[0][1].device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {f} must be float32 on "
                             f"{acts[0][1].device}, got {t.dtype} on "
                             f"{t.device}")
        if tuple(t.shape) != shapes[f]:
            raise ValueError(f"{name}: {f} has shape {tuple(t.shape)}, "
                             f"expected {shapes[f]}")


class Weights:
    """The weights the kernels read: ``p``'s matrices and biases in the
    compute dtype (the activations'), f32 LN, as attributes (``w.wo``);
    for float32 also the TF32 pairs of each matrix (``pair``): the forward
    GEMMs' and the backward dX GEMM's, from one pack (the dW GEMM reads no
    weight)."""

    def __init__(self, p, dtype: torch.dtype):
        self.p = type(p)(*(t.float().contiguous() if f in ("g", "b")
                           else t.to(dtype).contiguous()
                           for f, t in zip(p._fields, p)))
        self.tf32 = (lf.pack_tf32(self.p, nt=True)
                     if dtype == torch.float32 else None)

    def __getattr__(self, name):
        return getattr(self.p, name)

    def pair(self, name: str, nt: bool = False):
        """The TF32 pair of matrix ``name`` (``nt``: the dX GEMM's) or None
        for bfloat16."""
        return None if self.tf32 is None else \
            self.tf32[name + "_nt" if nt else name]


def compute_weights(p, dtype: torch.dtype) -> Weights:
    """The weights the kernels read (the cast, and for float32 the TF32
    pack, that the training step makes once, in the forward, for the
    forward and the backward)."""
    return Weights(p, dtype)


class _Fwd(NamedTuple):
    """Forward internals the backward reads (2-D row-major)."""

    xs: torch.Tensor      # the layer input the projections read
    qkv: torch.Tensor     # self-attention: packed q/k/v; cross: q
    kv: torch.Tensor | None
    heads: torch.Tensor
    a1: torch.Tensor      # pre-LN sums
    y: torch.Tensor
    midd: torch.Tensor    # masked ReLU output of the FFN
    a2: torch.Tensor
    z: torch.Tensor | None


def _untapped(name, t):
    return t


def _scoped(tap, scope):
    """``tap`` with its names prefixed by ``scope.``."""
    if tap is _untapped:
        return tap
    return lambda name, t: tap(f"{scope}.{name}", t)


def _ffn_tail_cuda(attn, res, w, seed, rate, keep, tap=_untapped):
    hid, pf, dt = res.shape[1], w.w1.shape[1], res.dtype
    y, a1 = _gemm_res_ln(attn, w.wo, w.bo, res, w.g, w.b,
                         _site(seed, _SITE_ATTN_OUT, hid, rate, dt), pre=keep,
                         pair=w.pair("wo"))
    if keep:
        y, a1 = tap("y", y), tap("a1", a1)
    midd = tap("midd", _gemm_bias(y, w.w1, w.b1, relu=True,
                                  site=_site(seed, _SITE_FFN_MID, pf, rate,
                                             dt), pair=w.pair("w1")))
    z, a2 = _gemm_res_ln(midd, w.w2, w.b2, y, w.g, w.b,
                         _site(seed, _SITE_FFN_OUT, hid, rate, dt), pre=keep,
                         out=not keep, pair=w.pair("w2"))
    if keep:
        a2 = tap("a2", a2)
    return y, a1, midd, a2, z


def _enc_fwd_cuda(x, w, seed, n_heads, rate, emb_drop, keep=False,
                  tap=_untapped, stem=False):
    n, l, hid = x.shape
    if rate > 0 and emb_drop:
        x = apply_keep_mask(x, seed, _SITE_EMB, rate)
    xs = tap("x", x.view(n * l, hid))
    if stem and x.dtype == torch.float32:
        # fed by the stem: its QKV on the CUDA cores, as the inference
        # layer's (layer_fused._encoder_layer_cuda)
        qkv = tap("qkv", lf._gemm_ffma(xs, w.wqkv, w.bqkv))
    else:
        qkv = tap("qkv", _gemm_bias(xs, w.wqkv, w.bqkv,
                                    pair=w.pair("wqkv")))
    heads = tap("heads", _attention(qkv[:, :hid], qkv[:, hid:2 * hid],
                                    qkv[:, 2 * hid:], n, n_heads, seed, rate,
                                    _SITE_ATTN, ffma_scores=stem))
    y, a1, midd, a2, z = _ffn_tail_cuda(heads, xs, w, seed, rate, keep, tap)
    return _Fwd(xs, qkv, None, heads, a1, y, midd, a2, z)


def _ffn_tail_bwd_cuda(f, dz, w, seed, rate, ln, tap):
    """From dz to the gradient at the attention output; returns (da1,
    dattn, grads of wo/bo/w1/b1/w2/b2)."""
    hid, pf, dt = dz.shape[1], w.w1.shape[1], dz.dtype
    da2, dff = _ln_backward(dz, f.a2, w.g,
                            _site(seed, _SITE_FFN_OUT, hid, rate, dt), ln)
    da2, dff = tap("da2", da2), tap("dff", dff)
    dw2, db2 = _weight_grad(f.midd, dff)
    du = tap("du", _gemm_nt(dff, w.w2, gate=f.midd,
                            m1=_site(seed, _SITE_FFN_MID, pf, rate, dt),
                            pair=w.pair("w2", nt=True)))
    dw1, db1 = _weight_grad(f.y, du)
    dy = tap("dy", _gemm_nt(du, w.w1, addend=da2,
                            pair=w.pair("w1", nt=True)))
    da1, dattn = _ln_backward(dy, f.a1, w.g,
                              _site(seed, _SITE_ATTN_OUT, hid, rate, dt), ln)
    da1, dattn = tap("da1", da1), tap("dattn", dattn)
    dwo, dbo = _weight_grad(f.heads, dattn)
    return da1, dattn, dict(wo=dwo, bo=dbo, w1=dw1, b1=db1, w2=dw2, b2=db2)


def _enc_bwd_cuda(x, w, seed, dz, n_heads, rate, emb_drop, tap=_untapped,
                  stem=False):
    n, l, hid = x.shape
    m = n * l
    f = _enc_fwd_cuda(x, w, seed, n_heads, rate, emb_drop, keep=True,
                      tap=tap, stem=stem)
    ln = _LnGrads(m, hid, 2, x.device, x.dtype)
    da1, dattn, grads = _ffn_tail_bwd_cuda(f, dz.view(m, hid), w, seed, rate,
                                           ln, tap)
    dheads = tap("dheads", _gemm_nt(dattn, w.wo,
                                    pair=w.pair("wo", nt=True)))
    dqkv = torch.empty((m, 3 * hid), dtype=x.dtype, device=x.device)
    q = f.qkv
    # fed by the stem (scores near 2^14): f32 scores as the forward's
    _attention_bwd(q[:, :hid], q[:, hid:2 * hid], q[:, 2 * hid:], dheads,
                   dqkv[:, :hid], dqkv[:, hid:2 * hid], dqkv[:, 2 * hid:], n,
                   n_heads, seed, rate, _SITE_ATTN, ffma_scores=stem)
    dqkv = tap("dqkv", dqkv)
    dwqkv, dbqkv = _weight_grad(f.xs, dqkv)
    m0 = _site(seed, _SITE_EMB, hid, rate, x.dtype) if emb_drop else None
    dx = tap("dx", _gemm_nt(dqkv, w.wqkv, addend=da1, m2=m0,
                            pair=w.pair("wqkv", nt=True)))
    dg, db = ln.reduce()
    return dx.view(n, l, hid), EncoderLayerParams(
        wqkv=dwqkv, bqkv=dbqkv, g=dg, b=db, **grads)


def _cross_fwd_cuda(t2, e2, w, n, seed, n_heads, rate, keep=False,
                    tap=_untapped):
    hid = t2.shape[1]
    q = tap("q", _gemm_bias(t2, w.wq, w.bq, pair=w.pair("wq")))
    kv = tap("kv", _gemm_bias(e2, w.wkv, w.bkv, pair=w.pair("wkv")))
    heads = tap("heads", _attention(q, kv[:, :hid], kv[:, hid:], n, n_heads,
                                    seed, rate, _SITE_ATTN))
    y, a1, midd, a2, z = _ffn_tail_cuda(heads, t2, w, seed, rate, keep, tap)
    return _Fwd(t2, q, kv, heads, a1, y, midd, a2, z)


def _cross_bwd_cuda(t2, e2, dz2, w, n, seed, n_heads, rate, ln, tap):
    """(dtrg, denc, grads of the cross tail's 12 fields)."""
    hid = t2.shape[1]
    f = _cross_fwd_cuda(t2, e2, w, n, seed, n_heads, rate, keep=True,
                        tap=tap)
    da1, dattn, grads = _ffn_tail_bwd_cuda(f, dz2, w, seed, rate, ln, tap)
    dheads = tap("dheads", _gemm_nt(dattn, w.wo,
                                    pair=w.pair("wo", nt=True)))
    dq = torch.empty_like(t2)
    dkv = torch.empty((e2.shape[0], 2 * hid), dtype=e2.dtype,
                      device=e2.device)
    _attention_bwd(f.qkv, f.kv[:, :hid], f.kv[:, hid:], dheads, dq,
                   dkv[:, :hid], dkv[:, hid:], n, n_heads, seed, rate,
                   _SITE_ATTN)
    dq, dkv = tap("dq", dq), tap("dkv", dkv)
    grads["wq"], grads["bq"] = _weight_grad(t2, dq)
    grads["wkv"], grads["bkv"] = _weight_grad(e2, dkv)
    dtrg = tap("dtrg", _gemm_nt(dq, w.wq, addend=da1,
                                 pair=w.pair("wq", nt=True)))
    denc = tap("denc", _gemm_nt(dkv, w.wkv, pair=w.pair("wkv", nt=True)))
    return dtrg, denc, grads


def _self_prologue_cuda(t2, w, n, seed, n_heads, rate, keep=False,
                        tap=_untapped):
    hid = t2.shape[1]
    qkv = tap("qkv", _gemm_bias(t2, w.wsqkv, w.bsqkv, pair=w.pair("wsqkv")))
    sheads = tap("sheads", _attention(qkv[:, :hid], qkv[:, hid:2 * hid],
                                      qkv[:, 2 * hid:], n, n_heads, seed,
                                      rate, _SITE_SA))
    t1, a0 = _gemm_res_ln(sheads, w.wso, w.bso, t2, w.g, w.b,
                          _site(seed, _SITE_SA_OUT, hid, rate, t2.dtype),
                          pre=keep, pair=w.pair("wso"))
    if keep:
        t1, a0 = tap("t1", t1), tap("a0", a0)
    return t1, qkv, sheads, a0


def _dec_fwd_cuda(trg, enc, w, seed, n_heads, rate):
    n, lq, hid = trg.shape
    t2 = trg.view(n * lq, hid)
    if isinstance(w.p, DecLayerParams):
        t2, _, _, _ = _self_prologue_cuda(t2, w, n, seed, n_heads, rate)
    f = _cross_fwd_cuda(t2, enc.view(-1, hid), w, n, seed, n_heads, rate)
    return f.z.view(n, lq, hid)


def _dec_bwd_cuda(trg, enc, w, seed, dz, n_heads, rate, tap=_untapped):
    n, lq, hid = trg.shape
    t2, e2 = trg.view(n * lq, hid), enc.view(-1, hid)
    with_self = isinstance(w.p, DecLayerParams)
    ln = _LnGrads(n * lq, hid, 3 if with_self else 2, trg.device,
                  trg.dtype)
    cross, st = _scoped(tap, "cross"), _scoped(tap, "self")
    if not with_self:
        dtrg, denc, grads = _cross_bwd_cuda(t2, e2, dz.view(-1, hid), w, n,
                                            seed, n_heads, rate, ln, cross)
        dg, db = ln.reduce()
        grads.update(g=dg, b=db)
        return (dtrg.view(n, lq, hid), denc.view(enc.shape),
                DecZeroParams(**grads))
    t1, qkv, sheads, a0 = _self_prologue_cuda(t2, w, n, seed, n_heads, rate,
                                              keep=True, tap=st)
    dt1, denc, grads = _cross_bwd_cuda(t1, e2, dz.view(-1, hid), w, n, seed,
                                       n_heads, rate, ln, cross)
    da0, dsa = _ln_backward(dt1, a0, w.g,
                            _site(seed, _SITE_SA_OUT, hid, rate, trg.dtype),
                            ln)
    da0, dsa = st("da0", da0), st("dsa", dsa)
    grads["wso"], grads["bso"] = _weight_grad(sheads, dsa)
    dsheads = st("dsheads", _gemm_nt(dsa, w.wso,
                                     pair=w.pair("wso", nt=True)))
    dqkv = torch.empty((n * lq, 3 * hid), dtype=trg.dtype, device=trg.device)
    _attention_bwd(qkv[:, :hid], qkv[:, hid:2 * hid], qkv[:, 2 * hid:],
                   dsheads, dqkv[:, :hid], dqkv[:, hid:2 * hid],
                   dqkv[:, 2 * hid:], n, n_heads, seed, rate, _SITE_SA)
    dqkv = st("dqkv", dqkv)
    grads["wsqkv"], grads["bsqkv"] = _weight_grad(t2, dqkv)
    dtrg = st("dtrg", _gemm_nt(dqkv, w.wsqkv, addend=da0,
                                pair=w.pair("wsqkv", nt=True)))
    dg, db = ln.reduce()
    grads.update(g=dg, b=db)
    return dtrg.view(n, lq, hid), denc.view(enc.shape), DecLayerParams(**grads)


# -------------------------------------------------------- public wrappers --
#
# ``w``: the compute weights of ``p`` (:func:`compute_weights`), cast
# here when not given. ``tap(name, t) -> tensor`` (default none): a hook on
# the output of
# every kernel of the backward (its forward recompute included), named as
# in the plain twin's ``taps`` (``"cross."`` / ``"self."`` prefixes in the
# decoder); the next kernel reads what it returns. Training passes none; a
# check records ``t`` and returns the plain twin's same intermediate, so
# every kernel runs on the twin's own inputs through this wiring.

def encoder_layer_train_cuda(x, p: EncoderLayerParams, seed: int,
                             n_heads: int, rate: float,
                             emb_drop: bool = False, w=None,
                             stem: bool = False):
    """The K7 forward kernels on a CUDA ``x`` (bf16 or f32; ``stem``: the
    layer that the stem feeds, as in :func:`encoder_layer_train`)."""
    n, l, _ = x.shape
    _check("encoder_layer_train", [("x", x)], p, n_heads, l)
    with torch.cuda.device(x.device):
        w = compute_weights(p, x.dtype) if w is None else w
        z = _enc_fwd_cuda(x, w, seed, n_heads, rate, emb_drop,
                          stem=stem).z.view(x.shape)
    kernels.launches["encoder_layer_train"] += 1
    return z


def encoder_layer_train_bwd_cuda(x, p: EncoderLayerParams, seed: int, dz,
                                 n_heads: int, rate: float,
                                 emb_drop: bool = False, w=None, tap=None,
                                 stem: bool = False):
    """The K7 backward kernels: ``(dx, EncoderLayerParams of f32
    gradients)``."""
    n, l, _ = x.shape
    _check("encoder_layer_train", [("x", x), ("dz", dz)], p, n_heads, l)
    with torch.cuda.device(x.device):
        w = compute_weights(p, x.dtype) if w is None else w
        out = _enc_bwd_cuda(x, w, seed, dz, n_heads, rate, emb_drop,
                            tap or _untapped, stem)
    kernels.launches["encoder_layer_train_bwd"] += 1
    return out


def _dec_name(p) -> str:
    return ("decoder_layer_train" if isinstance(p, DecLayerParams)
            else "decoder_layer_zero_train")


def decoder_layer_train_cuda(trg, enc, p, seed: int, n_heads: int,
                             rate: float, w=None):
    """The K8 (``DecZeroParams``) or K9 (``DecLayerParams``) forward
    kernels on CUDA tensors (bf16 or f32)."""
    name = _dec_name(p)
    _check(name, [("trg", trg), ("enc", enc)], p, n_heads,
           max(trg.shape[1], enc.shape[1]))
    with torch.cuda.device(trg.device):
        w = compute_weights(p, trg.dtype) if w is None else w
        z = _dec_fwd_cuda(trg, enc, w, seed, n_heads, rate)
    kernels.launches[name] += 1
    return z


def decoder_layer_train_bwd_cuda(trg, enc, p, seed: int, dz, n_heads: int,
                                 rate: float, w=None, tap=None):
    """The K8 / K9 backward kernels: ``(dtrg, denc, params of f32
    gradients)``."""
    name = _dec_name(p)
    _check(name, [("trg", trg), ("enc", enc)], p, n_heads,
           max(trg.shape[1], enc.shape[1]))
    kernels.check_cuda(f"{name}: dz", dz, trg.dtype, ndim=3)
    with torch.cuda.device(trg.device):
        w = compute_weights(p, trg.dtype) if w is None else w
        out = _dec_bwd_cuda(trg, enc, w, seed, dz, n_heads, rate,
                            tap or _untapped)
    kernels.launches[name + "_bwd"] += 1
    return out


class _EncoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, n_heads, rate, emb_drop, stem, *weights):
        p = EncoderLayerParams(*weights)
        ctx.save_for_backward(x, *weights)
        ctx.cfg = (seed, n_heads, rate, emb_drop, stem)
        if x.device.type == "cpu":
            return encoder_layer_train_plain(x, p, seed, n_heads, rate,
                                             emb_drop)
        ctx.w = compute_weights(p, x.dtype)
        return encoder_layer_train_cuda(x, p, seed, n_heads, rate, emb_drop,
                                        ctx.w, stem)

    @staticmethod
    def backward(ctx, dz):
        x, *weights = ctx.saved_tensors
        seed, n_heads, rate, emb_drop, stem = ctx.cfg
        p = EncoderLayerParams(*weights)
        dz = dz.contiguous()
        if x.device.type == "cpu":
            dx, dp = encoder_layer_train_bwd_plain(x, p, seed, dz, n_heads,
                                                   rate, emb_drop)
        else:
            dx, dp = encoder_layer_train_bwd_cuda(x, p, seed, dz, n_heads,
                                                  rate, emb_drop, ctx.w,
                                                  stem=stem)
        return (dx, None, None, None, None, None, *dp)


class _DecoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, trg, enc, seed, n_heads, rate, cls, *weights):
        p = cls(*weights)
        ctx.save_for_backward(trg, enc, *weights)
        ctx.cfg = (seed, n_heads, rate, cls)
        if trg.device.type == "cpu":
            plain = (decoder_layer_train_plain if cls is DecLayerParams
                     else decoder_layer_zero_train_plain)
            return plain(trg, enc, p, seed, n_heads, rate)
        ctx.w = compute_weights(p, trg.dtype)
        return decoder_layer_train_cuda(trg, enc, p, seed, n_heads, rate,
                                        ctx.w)

    @staticmethod
    def backward(ctx, dz):
        trg, enc, *weights = ctx.saved_tensors
        seed, n_heads, rate, cls = ctx.cfg
        p = cls(*weights)
        dz = dz.contiguous()
        if trg.device.type == "cpu":
            fn = (decoder_layer_train_bwd_plain if cls is DecLayerParams
                  else decoder_layer_zero_train_bwd_plain)
            dtrg, denc, dp = fn(trg, enc, p, seed, dz, n_heads, rate)
        else:
            dtrg, denc, dp = decoder_layer_train_bwd_cuda(
                trg, enc, p, seed, dz, n_heads, rate, ctx.w)
        return (dtrg, denc, None, None, None, None, *dp)


def encoder_layer_train(x, p: EncoderLayerParams, seed: int, n_heads: int,
                        rate: float, emb_drop: bool = False,
                        stem: bool = False):
    """Training forward of one self-attention block, differentiable wrt
    ``x`` and every field of ``p`` (float32). ``seed`` (a Python int in
    [0, 2**31)) drives the dropout masks; ``emb_drop`` also drops the
    layer's input (site ``_SITE_EMB``); ``stem`` marks the layer that the
    stem feeds, whose float32 QKV runs on the CUDA cores in its forward
    and its recompute, as the inference stem layer's does, and whose
    float32 attention backward recomputes the scores on FFMA, as the
    forward computes them (the plain version is the same function either
    way)."""
    return _EncoderLayerTrain.apply(x.contiguous(), int(seed), n_heads,
                                    float(rate), bool(emb_drop), bool(stem),
                                    *p)


def decoder_layer_zero_train(trg, enc, p: DecZeroParams, seed: int,
                             n_heads: int, rate: float):
    """Training forward of the cross-attention-only decoder block."""
    return _DecoderLayerTrain.apply(trg.contiguous(), enc.contiguous(),
                                    int(seed), n_heads, float(rate),
                                    DecZeroParams, *p)


def decoder_layer_train(trg, enc, p: DecLayerParams, seed: int, n_heads: int,
                        rate: float):
    """Training forward of the self+cross decoder block."""
    return _DecoderLayerTrain.apply(trg.contiguous(), enc.contiguous(),
                                    int(seed), n_heads, float(rate),
                                    DecLayerParams, *p)


__all__ = ["DecLayerParams", "DecZeroParams", "EncoderLayerParams",
           "decoder_layer_train", "decoder_layer_zero_train",
           "encoder_layer_train"]
