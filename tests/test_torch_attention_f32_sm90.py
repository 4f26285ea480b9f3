"""The f32 attention's views and launches, and the stem kernel's widths, on
the host (no card).

``csrc/mha_f32.cu`` reads q, k, v (and dO) by TMA from the strided views
its callers pass, through a 3-D tensor map a view: TMA takes a 16-byte
aligned base and row strides that are a multiple of 16 bytes (4 floats).
The layer that the stem feeds computes its scores on FFMA (the plain
GEMM's summation order), through entry points of its own. These tests drive
the wrappers on meta tensors with the kernel calls recorded (nothing is
built or launched), at a few milliseconds to a few seconds each:

1. The f32 layer route (``ops/layer_fused.py::_attention``, the training
   layers' forward and backward, and their FFMA-score forms) refuses a
   view TMA cannot take with a ``ValueError`` before any call: a
   misaligned base, a misaligned row stride, rows that overlap.
2. It admits the packed QKV and KV views of the paper (hid 256 over 4
   heads), default (64 over 2) and hid-96 (over 3) layers, and hands the
   entry points their strides.
3. The default f32 engine forward calls the f32 forward entry once a
   layer, the FFMA-score one for the stem-fed layer alone; a default f32
   fused training step (forward, then backward) calls the dropout forward
   and the backward once a layer in each direction, the FFMA-score
   forms for the stem-fed layer alone.
4. The stem kernel's wrapper admits hid 96 (a ragged last block of 64
   columns) and still refuses n_bin % 8 and n_frame % 4.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.models import fused_train
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.ops import layer_fused as lf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

F32 = torch.float32
FWD = ("nylon_attention_f32", "nylon_attention_drop_f32",
       "nylon_attention_ffma_f32")
BWD = ("nylon_attention_bwd_f32", "nylon_attention_bwd_ffma_f32")


@pytest.fixture
def calls(monkeypatch):
    """The (entry point, its arguments) of every kernel call; meta tensors
    through the kernel route (the device guard, the CUDA check and the SM
    count stubbed)."""
    seen = []
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)

    def check_cuda(name, t, dtype, ndim=None):
        assert t.device.type == "meta" and t.dtype == dtype, (name, t)

    monkeypatch.setattr(kernels, "check_cuda", check_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tlt, "_sm_count", lambda index: 132)  # an H100's
    return seen


def _meta(*shape):
    return torch.empty(shape, dtype=F32, device="meta")


def _routes(q, k, v, n, heads):
    """Every wrapper that hands an f32 view to the attention entry points:
    the inference layer's (3xTF32 and FFMA scores), the training layer's
    with dropout (both), and the backward's (both; dq, dk, dv written
    into views shaped like q, k, v)."""
    return (lambda: lf._attention(q, k, v, n, heads),
            lambda: lf._attention(q, k, v, n, heads, ffma_scores=True),
            lambda: tlt._attention(q, k, v, n, heads, 3, 0.1, 0),
            lambda: tlt._attention(q, k, v, n, heads, 3, 0.1, 0,
                                   ffma_scores=True),
            lambda: tlt._attention_bwd(q, k, v, q, q, k, v, n, heads, 3,
                                       0.1, 0),
            lambda: tlt._attention_bwd(q, k, v, q, q, k, v, n, heads, 3,
                                       0.1, 0, ffma_scores=True))


def _bad_views(hid, rows):
    """(what is wrong, q, k, v) of row-strided f32 views TMA cannot take."""
    qkv = _meta(rows, 3 * hid + 4)
    odd = _meta(rows, 3 * hid + 2)          # rows 8 bytes off 16
    flat = _meta(rows * hid)
    return [
        ("base", qkv[:, 2:2 + hid], qkv[:, hid + 4:2 * hid + 4],
         qkv[:, 2 * hid + 4:3 * hid + 4]),
        ("row stride", odd[:, :hid], odd[:, hid:2 * hid],
         odd[:, 2 * hid:3 * hid]),
        ("overlapping rows", flat.as_strided((rows, hid), (hid - 4, 1)),
         flat.as_strided((rows, hid), (hid - 4, 1)),
         flat.as_strided((rows, hid), (hid - 4, 1))),
    ]


@pytest.mark.parametrize("case", range(3))
def test_f32_layer_route_refuses_views_tma_cannot_take(calls, case):
    hid, heads, n, lq = 64, 2, 2, 256
    what, q, k, v = _bad_views(hid, n * lq)[case]
    for route in _routes(q, k, v, n, heads):
        with pytest.raises(ValueError):
            route()
    assert calls == [], what


# (hid, heads): the paper's layers, the default's, and hid 96 over 3 heads
WIDTHS = [(256, 4), (64, 2), (96, 3)]


@pytest.mark.parametrize("hid,heads", WIDTHS)
def test_f32_layer_route_admits_packed_views(calls, hid, heads):
    n, lq, lk = 2, 88, 256
    qkv = _meta(n * lk, 3 * hid)          # a self-attention's packed QKV
    q, kv = _meta(n * lq, hid), _meta(n * lk, 2 * hid)   # a cross's
    d = hid // heads
    for route in _routes(qkv[:, :hid], qkv[:, hid:2 * hid],
                         qkv[:, 2 * hid:], n, heads):
        route()
    for route in _routes(q, kv[:, :hid], kv[:, hid:], n, heads):
        route()
    got = [(name, a[4:9] if name in FWD else a[7:12],
            a[9:13] if name in FWD else a[12:17]) for name, a in calls]
    self_, cross = (n, lk, lk, heads, d), (n, lq, lk, heads, d)
    s3, c_fwd = (3 * hid, lk * 3 * hid, 3 * hid, lk * 3 * hid), \
        (hid, lq * hid, 2 * hid, lk * 2 * hid)
    c_bwd = (hid, 2 * hid, hid, hid, 2 * hid)
    assert got == [
        ("nylon_attention_f32", self_, s3),
        ("nylon_attention_ffma_f32", self_, s3),
        ("nylon_attention_drop_f32", self_, s3),
        ("nylon_attention_ffma_f32", self_, s3),
        ("nylon_attention_bwd_f32", self_, (3 * hid,) * 5),
        ("nylon_attention_bwd_ffma_f32", self_, (3 * hid,) * 5),
        ("nylon_attention_f32", cross, c_fwd),
        ("nylon_attention_ffma_f32", cross, c_fwd),
        ("nylon_attention_drop_f32", cross, c_fwd),
        ("nylon_attention_ffma_f32", cross, c_fwd),
        ("nylon_attention_bwd_f32", cross, c_bwd),
        ("nylon_attention_bwd_ffma_f32", cross, c_bwd),
    ]
    # every stride TMA reads: 16-byte multiples
    assert all(s * 4 % 16 == 0 for _, _, strides in got for s in strides)
    # the FFMA-score forward: active 0 without dropout, 1 with it, before
    # the dropout site's constants
    ffma = [a[14] for name, a in calls if name == "nylon_attention_ffma_f32"]
    assert ffma == [0, 1, 0, 1]


def _default_f32(B=1):
    cfg = Config()
    assert cfg.model.compute_dtype == "float32"
    model = HFT(cfg, "meta")
    spec = torch.zeros((B, cfg.feature.n_bins, cfg.input.margin_b
                        + cfg.input.num_frame + cfg.input.margin_f),
                       device="meta")
    return cfg, model, spec


def _n_sites(cfg):
    """The attention launches of a forward (one a layer, the stem-fed
    frequency layer among them) and of a training step's backward."""
    m = cfg.model
    return m.enc_layer + 1 + 2 * (m.dec_layer - 1) + m.dec_layer


def test_default_f32_forward_calls_the_ffma_scores_for_the_stem_layer(calls):
    B = 2
    cfg, model, spec = _default_f32(B)
    packed = engine.pack_params(model, F32)
    out = engine.forward(packed, spec, cfg)
    assert out["onset_A"].shape[:2] == (B, cfg.input.num_frame)
    names = [name for name, _ in calls if name in FWD]
    # the stem-fed layer first, on FFMA scores; every other layer on 3xTF32
    assert names == ["nylon_attention_ffma_f32"] + \
        ["nylon_attention_f32"] * (_n_sites(cfg) - 1)
    stem = next(a for name, a in calls if name == "nylon_attention_ffma_f32")
    m = cfg.model
    assert stem[4:9] == (B * cfg.input.num_frame, cfg.feature.n_bins,
                         cfg.feature.n_bins, m.enc_head,
                         m.hid_dim // m.enc_head)
    assert stem[14] == 0   # no dropout in inference
    assert not any(name in BWD for name, _ in calls)


def test_default_f32_train_step_calls_the_ffma_forms_for_the_stem_layer(calls):
    cfg, model, spec = _default_f32(1)
    seeds = dict.fromkeys(fused_train.seed_slots(cfg), 5)
    out = fused_train.train_forward(model, spec, seeds)
    sum(v.float().sum() for v in out.values()).backward()
    fwd = [name for name, _ in calls if name in FWD]
    bwd = [name for name, _ in calls if name in BWD]
    n = _n_sites(cfg)
    # the forward, then each layer's recompute in its backward; the stem-fed
    # layer's on FFMA scores, with its dropout site (active 1)
    assert sorted(fwd) == sorted(["nylon_attention_ffma_f32"] * 2
                                 + ["nylon_attention_drop_f32"] * 2 * (n - 1))
    assert all(a[14] == 1 for name, a in calls
               if name == "nylon_attention_ffma_f32")
    assert sorted(bwd) == sorted(["nylon_attention_bwd_ffma_f32"]
                                 + ["nylon_attention_bwd_f32"] * (n - 1))


def _stem_args(hid, n_bin=256, n_frame=128, n_proc=65, B=1):
    total = n_frame + n_proc - 1
    return (_meta(B, total, n_bin), _meta(n_proc, hid), _meta(hid),
            _meta(n_bin, hid), n_frame, F32)


@pytest.mark.parametrize("hid", [96, 64, 256])
def test_stem_kernel_admits_hid_of_any_admitted_width(calls, hid):
    out = lf._stem_embed(*_stem_args(hid))
    assert tuple(out.shape) == (128, 256, hid)
    (name, args), = calls
    assert name == "nylon_stem_embed_f32" and args[10] == hid


@pytest.mark.parametrize("kw", [dict(n_bin=252), dict(n_frame=126)])
def test_stem_kernel_still_refuses_its_other_limits(calls, kw):
    with pytest.raises(ValueError):
        lf._stem_embed(*_stem_args(96, **kw))
    assert calls == []
