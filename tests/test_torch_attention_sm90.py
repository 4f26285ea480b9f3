"""The bf16 attention's views and launches, on the host (no card).

``csrc/mha.cu`` reads q, k, v (and dO) by TMA from the strided views its
callers pass, through a 3-D tensor map a view: TMA takes a 16-byte
aligned base and row strides that are a multiple of 16 bytes. These tests
drive the wrappers on meta tensors with the kernel calls recorded (nothing
is built or launched), at a few milliseconds each:

1. The layer route (``ops/layer_fused.py::_attention``, and the training
   layers' forward and backward) refuses a view TMA cannot take with a
   ``ValueError`` before any call: a misaligned base, a misaligned row
   stride, rows that overlap.
2. It admits the packed QKV and KV views of the paper (hid 256 over 4
   heads), default (64 over 2) and hid-96 (over 3) layers, and hands the
   entry points their strides.
3. The engine's bf16 forward at the paper's layer counts and widths calls
   the forward entry point 11 times (3 frequency self, 3 cross, 2 note
   self, 3 time self), and a fused bf16 training step (forward, then
   backward) calls the dropout forward 22 times (each layer's backward
   recomputes its forward) and the backward 11 times, each with the
   strides its layer passes.
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.config import Config, ModelConfig
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.models import fused_train
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.ops import layer_fused as lf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

BF16 = torch.bfloat16
FWD = ("nylon_attention", "nylon_attention_drop")
BWD = "nylon_attention_bwd"


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
    return torch.empty(shape, dtype=BF16, device="meta")


def _routes(q, k, v, n, heads):
    """Every wrapper that hands a view to the attention entry points: the
    inference layer's, the training layer's with dropout, and the
    backward's (dq, dk, dv written into views shaped like q, k, v)."""
    return (lambda: lf._attention(q, k, v, n, heads),
            lambda: tlt._attention(q, k, v, n, heads, 3, 0.1, 0),
            lambda: tlt._attention_bwd(q, k, v, q, q, k, v, n, heads, 3,
                                       0.1, 0))


def _bad_views(hid, rows):
    """(what is wrong, q, k, v) of row-strided views TMA cannot take."""
    qkv = _meta(rows, 3 * hid + 8)
    odd = _meta(rows, 3 * hid + 4)          # rows 8 bytes off 16
    flat = _meta(rows * hid)
    return [
        ("base", qkv[:, 4:4 + hid], qkv[:, hid + 8:2 * hid + 8],
         qkv[:, 2 * hid + 8:3 * hid + 8]),
        ("row stride", odd[:, :hid], odd[:, hid:2 * hid],
         odd[:, 2 * hid:3 * hid]),
        ("overlapping rows", flat.as_strided((rows, hid), (hid - 8, 1)),
         flat.as_strided((rows, hid), (hid - 8, 1)),
         flat.as_strided((rows, hid), (hid - 8, 1))),
    ]


@pytest.mark.parametrize("case", range(3))
def test_layer_route_refuses_views_tma_cannot_take(calls, case):
    hid, heads, n, lq = 256, 4, 2, 256
    what, q, k, v = _bad_views(hid, n * lq)[case]
    for route in _routes(q, k, v, n, heads):
        with pytest.raises(ValueError):
            route()
    assert calls == [], what


# (hid, heads): the paper's layers, the default's, and hid 96 over 3 heads
WIDTHS = [(256, 4), (64, 2), (96, 3)]


@pytest.mark.parametrize("hid,heads", WIDTHS)
def test_layer_route_admits_packed_views(calls, hid, heads):
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
    assert got == [
        ("nylon_attention", self_, (3 * hid, lk * 3 * hid, 3 * hid,
                                    lk * 3 * hid)),
        ("nylon_attention_drop", self_, (3 * hid, lk * 3 * hid, 3 * hid,
                                         lk * 3 * hid)),
        (BWD, self_, (3 * hid,) * 5),
        ("nylon_attention", cross, (hid, lq * hid, 2 * hid, lk * 2 * hid)),
        ("nylon_attention_drop", cross, (hid, lq * hid, 2 * hid,
                                         lk * 2 * hid)),
        (BWD, cross, (hid, 2 * hid, hid, hid, 2 * hid)),
    ]
    # every stride and base TMA reads or writes: 16-byte multiples
    assert all(s * 2 % 16 == 0 for _, _, strides in got for s in strides)


def _paper_bf16(B=1):
    cfg = Config(model=dataclasses.replace(ModelConfig.paper_scale(),
                                           compute_dtype="bfloat16"))
    model = HFT(cfg, "meta")
    spec = torch.zeros((B, cfg.feature.n_bins, cfg.input.margin_b
                        + cfg.input.num_frame + cfg.input.margin_f),
                       device="meta")
    return cfg, model, spec


def _sites(cfg, B):
    """The paper forward's attention launches: (n, Lq, Lk, heads, D, q row
    stride, kv row stride) in the order the layers run."""
    m = cfg.model
    hid, heads, d = m.hid_dim, m.enc_head, m.hid_dim // m.enc_head
    n_frame, n_bin = cfg.input.num_frame, cfg.feature.n_bins
    n_note = cfg.midi.num_note
    freq = (B * n_frame, n_bin, n_bin, heads, d, 3 * hid, 3 * hid)
    cross = (B * n_frame, n_note, n_bin, heads, d, hid, 2 * hid)
    note = (B * n_frame, n_note, n_note, heads, d, 3 * hid, 3 * hid)
    time_ = (B * n_note, n_frame, n_frame, heads, d, 3 * hid, 3 * hid)
    return ([freq] * m.enc_layer + [cross] + [note, cross] * (m.dec_layer - 1)
            + [time_] * m.dec_layer)


def test_engine_forward_calls_the_attention_11_times(calls):
    B = 2
    cfg, model, spec = _paper_bf16(B)
    packed = engine.pack_params(model, BF16)
    out = engine.forward(packed, spec, cfg)
    assert out["onset_B"].shape[:2] == (B, cfg.input.num_frame)
    got = [a[4:9] + (a[9], a[11]) for name, a in calls if name in FWD]
    assert [name for name, _ in calls if name in FWD] == \
        ["nylon_attention"] * 11
    assert got == _sites(cfg, B)
    for a in (a for name, a in calls if name == "nylon_attention"):
        n, lq, lk = a[4:7]
        assert (a[10], a[12]) == (lq * a[9], lk * a[11])   # sequence strides


def test_fused_train_step_calls_the_backward_11_times(calls):
    B = 1
    cfg, model, spec = _paper_bf16(B)
    seeds = dict.fromkeys(fused_train.seed_slots(cfg), 5)
    out = fused_train.train_forward(model, spec, seeds)
    sum(v.float().sum() for v in out.values()).backward()
    fwd = [a[4:9] + (a[9], a[11]) for name, a in calls if name in FWD]
    bwd = [(name, a[7:12] + (a[12], a[13]), a[14:17]) for name, a in calls
           if name == BWD]
    assert {name for name, _ in calls if name in FWD} == \
        {"nylon_attention_drop"}
    sites = _sites(cfg, B)
    # the forward, then each layer's recompute in its backward (the layers
    # run backward in reverse order)
    assert sorted(fwd) == sorted(sites * 2)
    assert len(bwd) == 11
    hid = cfg.model.hid_dim
    for name, geo, (do_row, dq_row, dkv_row) in bwd:
        q_row, kv_row = geo[5:]
        assert do_row == hid
        assert (dq_row, dkv_row) == ((3 * hid, 3 * hid) if q_row == 3 * hid
                                     else (hid, 2 * hid))
    assert sorted(g for _, g, _ in bwd) == sorted(sites)
