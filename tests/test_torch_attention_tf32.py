"""The 3xTF32 arithmetic of the float32 attention (``csrc/mha_f32.cu``),
emulated on the CPU and held against the port's IEEE f32 plain versions at
the card's gates.

An f32 operand ``x`` splits into TF32 halves, ``big = rna(x)`` and ``small
= rna(x - big)`` (round to nearest at TF32's 10 stored mantissa bits, by bit
operations), and each matrix product is ``small @ big + big @ small + big @
big`` in f32 (a product of two TF32 values is exact in f32). The emulated
attention follows :func:`nylon_amt_tpu_torch.ops.attention.mha_plain` and
``mha_bwd_plain`` op for op with the kernels' products: every product (the
forward's S and PV, the backward's S, dP, dQ, dK, dV) as 3xTF32, K11's
probabilities from scores in f32 (the kernel's FFMA pass); and the form of
the layer that the stem feeds, whose forward scores are f32 (FFMA) too.
It must stay within ``chip_smoke.py``
(n)'s limits of the plain versions: outputs within 2e-5 of max(1, max
|plain|), input gradients within 1e-4 of max |plain|, K11's probabilities
within 1e-6. One TF32 pass per product misses those limits, and a negative
case asserts that it does, so the check tells the two schemes apart. Head
dims 32 and 64; 256, 128 and 88 keys; dropout off and on (K12's hash
masks).
"""

import math

import numpy as np
import pytest
import torch

from nylon_amt_tpu_torch.ops import attention as tatt
from nylon_amt_tpu_torch.ops.layer_fused import _LOG2E
from nylon_amt_tpu_torch.ops.precision import full_f32

from test_torch_ablation import one_thread  # noqa: F401 (autouse)

N, HEADS = 4, 2
RATE, SEED = 0.1, 987_654
OUT_REL, GRAD_REL, PROBS_ATOL = 2e-5, 1e-4, 1e-6  # chip_smoke.py (n)
SITES = [(88, 256), (128, 128), (88, 88)]  # (Lq, Lk): cross, time, note


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest (ties away from zero) at TF32's precision:
    half a TF32 ulp added to the bits, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def mm_3xtf32(a, b):
    """``a @ b`` as small*big + big*small + big*big, f32 sums."""
    a_big, b_big = rna_tf32(a), rna_tf32(b)
    a_small, b_small = rna_tf32(a - a_big), rna_tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_tf32(a, b):
    """``a @ b`` in one TF32 pass."""
    return rna_tf32(a) @ rna_tf32(b)


def attention(q, k, v, do, mask, scale, mm, score_mm=None, probs_mm=None):
    """(out, probs, dq, dk, dv) of mha_plain / mha_bwd_plain with every
    matrix product taken by ``mm``, but the forward's scores by
    ``score_mm`` and the probabilities' by ``probs_mm`` (default
    ``score_mm``) where given."""
    d = q.shape[-1] // HEADS
    outs, probs, dqs, dks, dvs = [], [], [], [], []
    for h in range(HEADS):
        sl = slice(h * d, (h + 1) * d)
        qh, kh, vh, doh = q[..., sl], k[..., sl], v[..., sl], do[..., sl]

        def softmax_of(mm_):
            s = mm_(qh, kh.transpose(-1, -2)) * (scale * _LOG2E)
            p = torch.exp2(s - s.amax(-1, keepdim=True))
            return p, p.sum(-1, keepdim=True)

        p, l = softmax_of(score_mm or mm)
        mk = None if mask is None else mask(h, tuple(p.shape))
        pd = p if mk is None else p * mk
        outs.append(mm(pd, vh) / l)
        p, l = softmax_of(probs_mm or score_mm or mm)
        probs.append(p / l)
        p, l = softmax_of(mm)  # the backward recomputes the scores
        a = p / l
        ad = a if mk is None else a * mk
        da = mm(doh, vh.transpose(-1, -2))
        if mk is not None:
            da = da * mk
        row = (da * a).sum(-1, keepdim=True)
        ds = a * (da - row)
        dqs.append(mm(ds, kh) * scale)
        dks.append(mm(ds.transpose(-1, -2), qh) * scale)
        dvs.append(mm(ad.transpose(-1, -2), doh))
    cat = lambda xs: torch.cat(xs, dim=-1)  # noqa: E731
    return (cat(outs), torch.stack(probs, dim=1), cat(dqs), cat(dks),
            cat(dvs))


def errors(d, lq, lk, drop, mm, score_mm=None, probs_mm=None):
    """(output, probabilities, gradients) error of the emulation ``mm``
    (``score_mm`` for the forward's scores, ``probs_mm`` for the
    probabilities') from the plain f32 versions: of max(1, max |plain|),
    absolute, of max |plain|."""
    rng = np.random.default_rng(1000 * d + 10 * lq + lk + drop)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (N, n, HEADS * d)).astype(np.float32)) for n in (lq, lk, lk, lq))
    scale = 1.0 / math.sqrt(d)
    mask = ((lambda h, shape: tatt.hash_keep_mask_plain(
        SEED, h, 0, shape, RATE, torch.float32)) if drop else None)
    with full_f32():
        out, probs, dq, dk, dv = attention(q, k, v, do, mask, scale, mm,
                                           score_mm, probs_mm)
        want = tatt.mha_plain(q, k, v, HEADS, scale, mask)
        _, want_probs = tatt.mha_plain(q, k, v, HEADS, scale,
                                       with_probs=True)
        grads = tatt.mha_bwd_plain(q, k, v, do, HEADS, scale, mask)
    e_out = ((out - want).abs().max() / want.abs().max().clamp_min(1.0))
    e_probs = (probs - want_probs).abs().max() if not drop else 0.0
    e_grad = max(((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip((dq, dk, dv), grads))
    return float(e_out), float(e_probs), e_grad


@pytest.mark.parametrize("drop", [False, True], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("lq,lk", SITES, ids=[f"{a}x{b}" for a, b in SITES])
@pytest.mark.parametrize("d", [32, 64])
def test_3xtf32_within_the_f32_gates(d, lq, lk, drop):
    # the stem-fed layer's form: the forward's scores in f32 (FFMA)
    e_out, e_probs, e_grad = errors(d, lq, lk, drop, mm_3xtf32,
                                    score_mm=torch.matmul)
    assert e_out <= OUT_REL, e_out
    assert e_probs <= PROBS_ATOL, e_probs
    assert e_grad <= GRAD_REL, e_grad


@pytest.mark.parametrize("drop", [False, True], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("lq,lk", SITES, ids=[f"{a}x{b}" for a, b in SITES])
@pytest.mark.parametrize("d", [32, 64])
def test_3xtf32_scores_within_the_f32_gates(d, lq, lk, drop):
    # every other layer: the forward's scores as 3xTF32 too, K11's
    # probabilities from f32 (FFMA) scores
    e_out, e_probs, e_grad = errors(d, lq, lk, drop, mm_3xtf32,
                                    probs_mm=torch.matmul)
    assert e_out <= OUT_REL, e_out
    assert e_probs <= PROBS_ATOL, e_probs
    assert e_grad <= GRAD_REL, e_grad


@pytest.mark.parametrize("d", [32, 64])
def test_one_tf32_pass_misses_the_f32_gates(d):
    e_out, e_probs, _ = errors(d, 88, 256, False, mm_tf32)
    assert e_out > OUT_REL, e_out
    assert e_probs > PROBS_ATOL, e_probs


def test_rna_tf32_rounds_to_nearest():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2 * 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(rna_tf32(x), want)
    # x - big is exact and at most half a TF32 ulp of x
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    big = rna_tf32(y)
    assert ((y - big).abs() <= y.abs() * 2.0 ** -11).all()
