"""K6: the dropout keep mask of the training kernels, and its kernel.

Port of :func:`nylon_amt_tpu.ops.attention.hash_keep_mask`, bit for bit.
The mask is a pure function of an element's GLOBAL index in the
``(n * d1, w)`` view of its site (``w = d2``, or ``d2 / 2`` when ``d2 %
256 == 0`` and each 32-bit hash gives two 16-bit draws), mixed with the
caller's seed and a per-site tag, so the forward and backward kernels
regenerate the same masks in any launch geometry:

* ``lin = row0 * d1 * w + r * w + c`` (mod 2**32), ``x = lin ^ seed *
  0x9E3779B9 ^ tag * 0x85EBCA6B``, then xorshift-multiply
  (``x ^= x >> 16; x *= 0x7FEB352D; x ^= x >> 15; x *= 0x846CA68B``);
* unpacked: keep when ``x >= int(rate * 2**32)``; packed: the low 16 bits
  fill columns ``[0, d2/2)`` and the high 16 bits ``[d2/2, d2)``, keep when
  the draw ``>= round(rate * 65536)``;
* a kept element is ``1 / (1 - rate)`` (of the quantised rate when packed)
  rounded to float32 and then to ``dtype``, a dropped one 0.

:func:`hash_keep_mask_plain` computes it with int64 tensor arithmetic on
any device. :func:`hash_keep_mask` and :func:`apply_keep_mask` are the
wrappers: on a CPU tensor they take the plain version, on a CUDA device
they launch ``csrc/hash_mask.cu`` (the device function of
``csrc/hash_mask.cuh`` that the training kernels call in their epilogues)
on the grid that :func:`hash_mask_plan` mirrors and
:func:`hash_mask_walk` follows, or raise. :func:`dropout` is inverted
dropout on those masks, with its gradient.

K10, K11, K12: the per-site attention of :func:`nylon_amt_tpu.ops.attention.
fused_mha`, ``fused_mha_with_probs`` and ``fused_mha_dropout``, on the flat
``[N, L, H*D]`` layout of the projections, each a
:class:`torch.autograd.Function` whose backward recomputes the
probabilities, as the JAX custom VJPs do. The plain versions
(:func:`mha_plain`, :func:`mha_bwd_plain`) are the TPU kernels' bodies op
for op: f32 scores times ``scale * log2(e)``, ``exp2(s - m)``, ``l`` summed
from the unrounded f32 ``p``, ``bf16(p [* keep]) @ V`` in f32, and the
``1 / l`` deferred to the output; the backward casts ``ds`` and ``a`` (or
``a * keep``) to the compute dtype before their products. K12's mask of
head ``h`` is :func:`hash_keep_mask` with the raw tag ``h`` on the ``(N,
Lq, Lk)`` probabilities. A CPU tensor takes the plain versions; a CUDA
tensor launches ``csrc/mha.cu`` (bf16) or ``csrc/mha_f32.cu`` (float32),
head_dim 32 or 64, at most 256 queries and keys, or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops.layer_fused import _LOG2E, check_geometry
from nylon_amt_tpu_torch.ops.precision import full_f32

_U32 = 0xFFFFFFFF
_SEED_MUL = 0x9E3779B9
_TAG_MUL = 0x85EBCA6B
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def seed_mix(seed: int) -> int:
    """``seed * 0x9E3779B9`` mod 2**32 (the seed as uint32, as JAX casts
    it)."""
    return ((int(seed) & _U32) * _SEED_MUL) & _U32


def site_key(seed: int, tag: int) -> int:
    """The 32-bit word a site's linear index is xor-ed with."""
    return seed_mix(seed) ^ ((int(tag) * _TAG_MUL) & _U32)


def site_constants(rate: float, d2: int, dtype: torch.dtype
                   ) -> tuple[int, float, int]:
    """``(threshold, keep value, half)`` of a site whose rows are ``d2``
    long: ``half`` is ``d2 // 2`` when the draws are packed, else 0."""
    if d2 % 256:
        threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
        inv = 1.0 / (1.0 - rate)
        half = 0
    else:
        threshold = min(max(int(round(rate * 65536)), 1), 65535)
        inv = 65536.0 / (65536.0 - threshold)
        half = d2 // 2
    keep = torch.tensor(inv, dtype=torch.float32).to(dtype).float().item()
    return threshold, keep, half


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2**32 for int64 ``x`` in [0, 2**32), in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_values(key: int, threshold: int, keep: float, half: int,
                rows: int, d2: int, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu",
                base: int = 0) -> torch.Tensor:
    """The ``[rows, d2]`` keep mask of a site given by the kernels'
    constants (``csrc/hash_mask.cuh``'s ``DropSite``: ``key``, ``threshold``,
    ``keep`` value, ``half``, ``base``), by plain tensor arithmetic."""
    w = half or d2
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    x = hash32(r * w + c + base, key)

    def select(v):
        return torch.where(v >= threshold, keep, 0.0).to(torch.float32)

    if not half:
        out = select(x)
    else:
        out = torch.cat([select(x & 0xFFFF), select(x >> 16)], dim=-1)
    return out.to(dtype)


def hash32(lin: torch.Tensor, key: int) -> torch.Tensor:
    """The 32-bit hash of int64 linear indices ``lin`` (taken mod 2**32)
    under ``key``: ``hash_mix(lin ^ key)`` of ``csrc/hash_mask.cuh``."""
    x = (lin & _U32) ^ key
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    return _mul32(x, _MIX2)


def hash_keep_mask_plain(seed: int, tag: int, row0: int, shape, rate: float,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """The keep mask of ``shape = (n, d1, d2)`` on ``device``, by plain
    tensor arithmetic (the JAX function's ``row0`` included)."""
    n, d1, d2 = shape
    threshold, keep, half = site_constants(rate, d2, dtype)
    base = (int(row0) * d1 * (half or d2)) & _U32
    return keep_values(site_key(seed, tag), threshold, keep, half, n * d1,
                       d2, dtype, device, base).reshape(n, d1, d2)


# hash_mask_kernel's threads a block and items a thread has in flight (one
# 16-byte vector, or a pair when packed): csrc/hash_mask.cu kThreads,
# kUnroll
_HASH_THREADS, _HASH_UNROLL = 256, 2


class HashMaskPlan(NamedTuple):
    """How ``csrc/hash_mask.cu`` covers a ``(rows, d2)`` site view: 16-byte
    vectors of ``vec`` elements; packed (``half = d2 / 2``), ``width``
    items a row, an item the vectors at columns ``c`` and ``c + half`` (one
    hash each element pair); unpacked (``half`` 0), ``items`` vectors of
    the flat view, then ``tail`` scalar elements; a persistent grid of
    ``blocks`` blocks of _HASH_THREADS."""
    vec: int
    half: int
    width: int
    items: int
    tail: int
    blocks: int


def hash_mask_plan(rows: int, d2: int, dtype: torch.dtype, sms: int,
                   per_sm: int) -> HashMaskPlan:
    """The plan of the mask kernel over ``rows`` rows of ``d2`` elements of
    ``dtype`` on a card of ``sms`` SMs that hold ``per_sm`` of its blocks
    each (``nylon_hash_mask_occupancy``): the grid is at most one wave,
    and no larger than one item a thread. The entry point plans its own
    launch so (``nylon_hash_mask_grid`` reports it)."""
    vec = 16 // dtype.itemsize
    half = d2 // 2 if d2 % 256 == 0 else 0
    if half:
        width, tail = half // vec, 0
        items = rows * width
    else:
        width, (items, tail) = 0, divmod(rows * d2, vec)
    blocks = max(1, min(sms * per_sm, -(-items // _HASH_THREADS)))
    return HashMaskPlan(vec, half, width, items, tail, blocks)


def hash_mask_walk(plan: HashMaskPlan, rows: int, d2: int, base: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every element the kernel writes, in the order its threads take
    them (pass by pass, each thread's items in turn, a vector's elements
    in order): ``(lin, lo, hi)`` int64, ``lin`` the hash's linear index
    (mod 2**32), ``lo`` the flat index of the element its whole hash
    (unpacked) or its low draw (packed) keeps, ``hi`` that of the element
    its high draw keeps (packed; -1 unpacked). The packed walk is the
    kernel's: each thread's first (row, column vector) from one division,
    then a step of one grid of items with a carry."""
    stride = plan.blocks * _HASH_THREADS
    t = torch.arange(stride, dtype=torch.int64)
    e = torch.arange(plan.vec, dtype=torch.int64)
    lins, los, his = [], [], []
    if plan.half:
        w = plan.width
        row, c = t // w, t % w
        drow, dc = divmod(stride, w)
        while bool((row < rows).any()):
            for _ in range(_HASH_UNROLL):
                live = row < rows
                r, cv = row[live, None], c[live, None]
                lins.append(base + r * plan.half + cv * plan.vec + e)
                los.append(r * d2 + cv * plan.vec + e)
                his.append(los[-1] + plan.half)
                c = c + dc
                carry = c >= w
                row, c = row + drow + carry, c - w * carry
    else:
        for k0 in range(0, plan.items, stride):
            k = (k0 + t)[k0 + t < plan.items, None]
            los.append(k * plan.vec + e)
            lins.append(base + los[-1])
            his.append(torch.full_like(los[-1], -1))
        tail = plan.items * plan.vec + t[:plan.tail]
        los.append(tail)
        lins.append(base + tail)
        his.append(torch.full_like(tail, -1))
    lin, lo, hi = (torch.cat([a.flatten() for a in v])
                   for v in (lins, los, his))
    return lin & _U32, lo, hi


def check_hash_mask(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the mask kernel takes ``t`` (its input
    or output): bfloat16 or float32, contiguous from a 16-byte aligned
    start (the kernel moves 16-byte vectors), fewer than 2**31 elements
    (its index arithmetic is 32-bit)."""
    kernels.check_dtype(name, t.dtype)
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor must be contiguous from a "
                         f"16-byte aligned start")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements; the kernel takes "
                         f"fewer than 2**31")


def _launch(x, out, rows: int, d2: int, seed: int, tag: int, row0: int,
            d1: int, rate: float) -> None:
    threshold, keep, half = site_constants(rate, d2, out.dtype)
    base = (int(row0) * d1 * (half or d2)) & _U32
    kernels.call("nylon_hash_mask", None if x is None else x.data_ptr(),
                 out.data_ptr(), rows, d2, site_key(seed, tag), threshold,
                 keep, half, base, int(out.dtype == torch.bfloat16),
                 kernels.stream_of(out))
    kernels.launches["hash_keep_mask"] += 1


def hash_keep_mask(seed: int, tag: int, row0: int, shape, rate: float,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Dropout keep mask (scaled by ``1 / (1 - rate)``) of ``shape = (n,
    d1, d2)``: the plain version on the CPU, the K6 kernel on a CUDA
    device."""
    device = torch.device(device)
    if device.type == "cpu":
        return hash_keep_mask_plain(seed, tag, row0, shape, rate, dtype)
    kernels.check_dtype("hash_keep_mask", dtype)
    n, d1, d2 = shape
    out = torch.empty(shape, dtype=dtype, device=device)
    check_hash_mask("hash_keep_mask", out)
    with torch.cuda.device(device):
        _launch(None, out, n * d1, d2, seed, tag, row0, d1, rate)
    return out


def apply_keep_mask(x: torch.Tensor, seed: int, tag: int,
                    rate: float) -> torch.Tensor:
    """``x * hash_keep_mask(seed, tag, 0, x.shape, rate, x.dtype)`` for a
    3-D ``x``; on a CUDA tensor one launch of the K6 kernel (``x``
    contiguous from a 16-byte aligned start, or ``ValueError``)."""
    if x.device.type == "cpu":
        return x * hash_keep_mask_plain(seed, tag, 0, x.shape, rate, x.dtype)
    kernels.check_dtype("apply_keep_mask", x.dtype)
    kernels.check_cuda("apply_keep_mask: x", x, x.dtype, ndim=3)
    check_hash_mask("apply_keep_mask", x)
    n, d1, d2 = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch(x, out, n * d1, d2, seed, tag, 0, d1, rate)
    return out


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, tag, rate):
        ctx.args = (seed, tag, rate)
        return _keep(x, seed, tag, rate)

    @staticmethod
    def backward(ctx, dy):
        return _keep(dy, *ctx.args), None, None, None


def _keep(x, seed, tag, rate):
    flat = x.contiguous().reshape(1, -1, x.shape[-1])
    return apply_keep_mask(flat, seed, tag, rate).reshape(x.shape)


def dropout(x: torch.Tensor, seed: int, tag: int, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` with the keep mask of ``(seed, tag)`` on its
    ``(rows, last axis)`` view; the gradient takes the same mask. On a CUDA
    tensor each direction is one launch of the K6 kernel."""
    if rate <= 0.0:
        return x
    return _Dropout.apply(x, seed, tag, rate)


# ------------------------------------------------ K10, K11, K12: attention --

def _mm(a, b):
    """f32 product of (possibly bf16) operands: exact products, f32 sums."""
    return torch.matmul(a.float(), b.float())


def _head_scores(qh, kh, scale):
    """(a = p / l, p, l) of one head: exp2 of the scaled f32 scores."""
    s = _mm(qh, kh.transpose(-1, -2)) * (scale * _LOG2E)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return p / l, p, l


def mha_plain(q, k, v, n_heads: int, scale: float, mask=None,
              with_probs: bool = False):
    """Attention of ``q [N, Lq, H*D]`` over ``k, v [N, Lk, H*D]``, the TPU
    kernels' forward op for op; ``mask(h, shape)`` gives head ``h``'s keep
    mask on the probabilities (K12) or is None. With ``with_probs`` also the
    normalised f32 probabilities ``[N, H, Lq, Lk]`` (K11)."""
    dt = q.dtype
    d = q.shape[-1] // n_heads
    outs, probs = [], []
    with full_f32():
        for h in range(n_heads):
            sl = slice(h * d, (h + 1) * d)
            a, p, l = _head_scores(q[..., sl], k[..., sl], scale)
            pd = p if mask is None else p * mask(h, tuple(p.shape))
            outs.append((_mm(pd.to(dt), v[..., sl]) / l).to(dt))
            probs.append(a)
    out = torch.cat(outs, dim=-1)
    return (out, torch.stack(probs, dim=1)) if with_probs else out


def mha_bwd_plain(q, k, v, do, n_heads: int, scale: float, mask=None):
    """``(dq, dk, dv)`` of :func:`mha_plain`'s output given ``do``, the TPU
    backward kernels op for op (probabilities recomputed, masks
    regenerated)."""
    dt = q.dtype
    d = q.shape[-1] // n_heads
    dqs, dks, dvs = [], [], []
    with full_f32():
        for h in range(n_heads):
            sl = slice(h * d, (h + 1) * d)
            qh, kh, vh, doh = q[..., sl], k[..., sl], v[..., sl], do[..., sl]
            a, _, _ = _head_scores(qh, kh, scale)
            mk = None if mask is None else mask(h, tuple(a.shape))
            ad = a if mk is None else a * mk
            da = _mm(doh, vh.transpose(-1, -2))
            if mk is not None:
                da = da * mk
            row = (da * a).sum(-1, keepdim=True)
            ds = (a * (da - row)).to(dt)
            dqs.append((_mm(ds, kh) * scale).to(dt))
            dks.append((_mm(ds.transpose(-1, -2), qh) * scale).to(dt))
            dvs.append(_mm(ad.to(dt).transpose(-1, -2), doh).to(dt))
    return (torch.cat(dqs, dim=-1), torch.cat(dks, dim=-1),
            torch.cat(dvs, dim=-1))


def probs_cotangent_plain(q, k, dp, n_heads: int, scale: float):
    """``(dq, dk)`` of the softmax probabilities given their cotangent ``dp
    [N, H, Lq, Lk]``: ``_probs_cotangent_contribution`` of the JAX package,
    plain ops with an ``exp`` softmax on the recomputed scores (paid only
    when a loss differentiates through the returned map)."""
    n, lq, hid = q.shape
    lk = k.shape[1]
    d = hid // n_heads
    qh = q.reshape(n, lq, n_heads, d).float()
    kh = k.reshape(n, lk, n_heads, d).float()
    with full_f32():
        s = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * scale
        a = torch.softmax(s, dim=-1)
        dp = dp.float()
        row = (dp * a).sum(-1, keepdim=True)
        ds = (a * (dp - row)) * scale
        dq = torch.einsum("nhqk,nkhd->nqhd", ds, kh)
        dk = torch.einsum("nhqk,nqhd->nkhd", ds, qh)
    return (dq.reshape(n, lq, hid).to(q.dtype),
            dk.reshape(n, lk, hid).to(k.dtype))


def _plain_mask(seed, rate, device):
    """K12's keep mask of head h (raw tag h), or None at rate 0."""
    if rate <= 0.0:
        return None
    return lambda h, shape: hash_keep_mask_plain(seed, h, 0, shape, rate,
                                                 torch.float32, device)


def _check(name, q, k, v, n_heads):
    kernels.check_dtype(name, q.dtype)
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_cuda(f"{name}: {t_name}", t, q.dtype, ndim=3)
    n, lq, hid = q.shape
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != hid:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    check_geometry(name, hid, n_heads, lq, k.shape[1])


def _geometry(q, k, n_heads, scale):
    n, lq, hid = q.shape
    lk = k.shape[1]
    return (n, lq, lk, n_heads, hid // n_heads, hid, lq * hid, hid, lk * hid,
            scale * _LOG2E)


def _fwd_cuda(q, k, v, n_heads, scale, rate, seed, with_probs=False):
    out = torch.empty_like(q)
    geo = _geometry(q, k, n_heads, scale)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = kernels.stream_of(q)
        if with_probs:
            n, lq, lk = geo[:3]
            probs = torch.empty((n, n_heads, lq, lk), dtype=torch.float32,
                                device=q.device)
            kernels.call(kernels.entry("nylon_attention_probs", q.dtype),
                         *ptrs, probs.data_ptr(), *geo, stream)
            return out, probs
        if rate > 0.0:
            thresh, keep, half = site_constants(rate, k.shape[1],
                                                torch.float32)
            kernels.call(kernels.entry("nylon_attention_drop", q.dtype),
                         *ptrs, *geo, seed_mix(seed), 0, thresh, keep, half,
                         stream)
        else:
            kernels.call(kernels.entry("nylon_attention", q.dtype), *ptrs,
                         *geo, stream)
    return out


def _bwd_cuda(q, k, v, do, n_heads, scale, rate, seed):
    kernels.check_cuda("attention backward: do", do, q.dtype, ndim=3)
    n, lq, hid = q.shape
    lk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    active = rate > 0.0
    thresh, keep, half = (site_constants(rate, lk, torch.float32) if active
                          else (0, 0.0, 0))
    with torch.cuda.device(q.device):
        kernels.call(kernels.entry("nylon_attention_bwd", q.dtype),
                     q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), n, lq, lk, n_heads,
                     hid // n_heads, hid, hid, hid, hid, hid,
                     scale, scale * _LOG2E, int(active), seed_mix(seed), 0,
                     thresh, keep, half, kernels.stream_of(q))
    return dq, dk, dv


class _FusedMHA(torch.autograd.Function):
    """K10 (rate 0) and K12 (rate > 0)."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale, rate, seed):
        ctx.save_for_backward(q, k, v)
        ctx.args = (n_heads, scale, rate, seed)
        if q.device.type == "cpu":
            return mha_plain(q, k, v, n_heads, scale,
                             _plain_mask(seed, rate, q.device))
        name = "fused_mha_dropout" if rate > 0.0 else "fused_mha"
        _check(name, q, k, v, n_heads)
        out = _fwd_cuda(q, k, v, n_heads, scale, rate, seed)
        kernels.launches[name] += 1
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        n_heads, scale, rate, seed = ctx.args
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = mha_bwd_plain(q, k, v, do, n_heads, scale,
                                  _plain_mask(seed, rate, q.device))
        else:
            grads = _bwd_cuda(q, k, v, do, n_heads, scale, rate, seed)
            kernels.launches["fused_mha_dropout_bwd" if rate > 0.0
                             else "fused_mha_bwd"] += 1
        return (*grads, None, None, None, None)


class _FusedMHAProbs(torch.autograd.Function):
    """K11: K10 that also returns the probabilities. A cotangent of the
    output takes K10's backward, one of the probabilities the plain
    :func:`probs_cotangent_plain`; an unused one costs nothing (None, as
    JAX's symbolic zero)."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v)
        ctx.args = (n_heads, scale)
        if q.device.type == "cpu":
            return mha_plain(q, k, v, n_heads, scale, with_probs=True)
        _check("fused_mha_with_probs", q, k, v, n_heads)
        out = _fwd_cuda(q, k, v, n_heads, scale, 0.0, 0, with_probs=True)
        kernels.launches["fused_mha_with_probs"] += 1
        return out

    @staticmethod
    def backward(ctx, do, dp):
        q, k, v = ctx.saved_tensors
        n_heads, scale = ctx.args
        if do is None:
            dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        elif q.device.type == "cpu":
            dq, dk, dv = mha_bwd_plain(q, k, v, do.contiguous(), n_heads,
                                       scale)
        else:
            dq, dk, dv = _bwd_cuda(q, k, v, do.contiguous(), n_heads, scale,
                                   0.0, 0)
            kernels.launches["fused_mha_with_probs_bwd"] += 1
        if dp is not None:
            dq2, dk2 = probs_cotangent_plain(q, k, dp, n_heads, scale)
            dq, dk = dq + dq2, dk + dk2
        return dq, dk, dv, None, None


def fused_mha(q, k, v, n_heads: int, scale: float) -> torch.Tensor:
    """K10: ``softmax(q k^T * scale) v`` per head on ``[N, L, H*D]``."""
    return _FusedMHA.apply(q, k, v, n_heads, scale, 0.0, 0)


def fused_mha_with_probs(q, k, v, n_heads: int, scale: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K11: K10's output and the probabilities ``[N, H, Lq, Lk]`` (f32)."""
    return _FusedMHAProbs.apply(q, k, v, n_heads, scale)


def fused_mha_dropout(q, k, v, n_heads: int, scale: float, rate: float,
                      seed: int) -> torch.Tensor:
    """K12: K10 with dropout on the normalised probabilities (``l`` from the
    unmasked ``p``), head ``h`` masked by ``hash_keep_mask(seed, h, ...)``
    on the ``(N, Lq, Lk)`` view; ``seed`` is JAX's int32 seed."""
    return _FusedMHA.apply(q, k, v, n_heads, scale, rate, seed)
