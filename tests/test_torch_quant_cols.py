"""V's column quantizer of the int8 attention (``csrc/layer_fused_q8.cu``'s
``quant_cols_kernel``, ``nylon_q8_quant_cols[_f32]``) on the CPU, in a few
seconds:

1. Its plain twin ``quant_cols_plain`` (the kernel's layout: the codes
   transposed per sequence, ``[n, hid, Lk_pad]`` with zero codes past Lk,
   and the scales ``[n, hid]``) against the JAX package's quantization of
   V in ``_mha_block_q8`` (the column absmax floored at 1e-12, the codes
   ``round(v * (127 / av))``, the scales ``av / 127^2``), bit for bit, in
   f32 and bf16, at the paper, default and hid-96 widths, on V slices of
   packed QKV and KV outputs, with an all-zero column.
2. The kernel route on meta tensors (the entry points recorded, nothing
   launched): the paper bf16 int8 forward calls the quantizer 11 times,
   each on V's strided view (row stride 3 hid in a self-attention's QKV,
   2 hid in a cross-attention's KV) with its sequences and keys.
3. The wrapper refuses with ``ValueError``, before any call, what the
   kernel does not take: more than 256 keys, hid % 8, rows that are not
   whole sequences, a view TMA cannot read, float16.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.config import Config, ModelConfig
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.ops import layer_fused_q8 as tq


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cols(v):
    """The JAX package's V quantizer (``ops/layer_fused_q8.py``
    ``_mha_block_q8``) on ``v [n, Lk, hid]``: (codes, scales [n, 1, hid])."""
    vf = jnp.asarray(v).astype(jnp.float32)
    av = jnp.maximum(jnp.max(jnp.abs(vf), axis=1, keepdims=True), 1e-12)
    vq = jnp.round(vf * (127.0 / av)).astype(jnp.int32).astype(jnp.int8)
    return np.asarray(vq), np.asarray(av * (1.0 / (127.0 * 127.0)))


# (hid, packed width: 3 for a self-attention's QKV, 2 for a cross KV, Lk)
CASES = [(256, 3, 256), (256, 2, 88), (64, 3, 128), (96, 2, 88),
         (96, 3, 40)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hid,width,lk", CASES)
def test_quant_cols_plain_matches_jax(hid, width, lk, dt):
    n = 3
    rng = np.random.default_rng(hid + lk)
    x = rng.standard_normal((n * lk, width * hid)).astype(np.float32)
    x[:, (width - 1) * hid + 5] = 0.0        # an all-zero column of V
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    v2 = torch.from_numpy(x).to(tdt)[:, (width - 1) * hid:]   # V's view
    vt, sv = tq.quant_cols_plain(v2, n)
    lk_pad = -(-lk // 32) * 32
    assert vt.dtype == torch.int8 and tuple(vt.shape) == (n, hid, lk_pad)
    assert sv.dtype == torch.float32 and tuple(sv.shape) == (n, hid)
    wq, ws = _jax_cols(np.asarray(jnp.asarray(x[:, (width - 1) * hid:])
                                  .astype(jdt)).reshape(n, lk, hid))
    np.testing.assert_array_equal(vt[:, :, :lk].transpose(1, 2).numpy(), wq)
    assert not vt[:, :, lk:].any()           # zero codes past Lk
    np.testing.assert_array_equal(sv.numpy(), ws[:, 0])
    assert (sv[:, 5] > 0).all()              # the floored scale


# ------------------------------------------ the route on meta tensors --

@pytest.fixture
def calls(monkeypatch):
    """The (entry point, its arguments) of every kernel call; meta tensors
    through the kernel route (the device guard and the CUDA check
    stubbed)."""
    seen = []
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)

    def check_cuda(name, t, dtype, ndim=None):
        assert t.device.type == "meta" and t.dtype == dtype, (name, t)

    monkeypatch.setattr(kernels, "check_cuda", check_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return seen


def test_paper_int8_forward_calls_the_quantizer_11_times(calls):
    B = 2
    cfg = Config(model=dataclasses.replace(ModelConfig.paper_scale(),
                                           compute_dtype="bfloat16"))
    packed = engine.pack_params(HFT(cfg, "meta"), torch.bfloat16,
                                precision="int8")
    # the K-major weight packs that pack_params makes on the card only
    packed = packed._replace(wt={
        g: [tq.pack_wt(p) for p in ps] if isinstance(ps, list)
        else tq.pack_wt(ps) for g, ps in (
            ("enc", packed.enc), ("dec_zero", packed.dec_zero),
            ("dec", packed.dec), ("time", packed.time))})
    i, m = cfg.input, cfg.model
    spec = torch.zeros((B, cfg.feature.n_bins, i.margin_b + i.num_frame
                        + i.margin_f), device="meta")
    out = engine.forward(packed, spec, cfg)
    assert out["onset_B"].shape[:2] == (B, i.num_frame)
    got = [a[1:5] for name, a in calls if name == "nylon_q8_quant_cols"]
    hid, frames, notes = m.hid_dim, B * i.num_frame, cfg.midi.num_note
    freq = (3 * hid, frames, cfg.feature.n_bins, hid)
    cross = (2 * hid, frames, cfg.feature.n_bins, hid)
    note = (3 * hid, frames, notes, hid)
    time_ = (3 * hid, B * notes, i.num_frame, hid)
    assert got == ([freq] * m.enc_layer + [cross]
                   + [note, cross] * (m.dec_layer - 1)
                   + [time_] * m.dec_layer)
    assert len(got) == 11


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _refusals():
    """(what is wrong, v2, n) the kernel does not take."""
    qkv = _meta(2 * 128, 3 * 96 + 4)        # rows 8 bytes off 16
    return [
        ("keys", _meta(300, 64), 1),
        ("hid % 8", _meta(2 * 128, 3 * 68)[:, 2 * 68:], 2),
        ("whole sequences", _meta(255, 64), 2),
        ("row stride", qkv[:, 2 * 96:3 * 96], 2),
        ("column stride", _meta(64, 2 * 128).t(), 1),
        ("float16", _meta(2 * 128, 64, dtype=torch.float16), 2),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_quant_cols_refuses_before_any_call(calls, case):
    what, v2, n = _refusals()[case]
    with pytest.raises(ValueError):
        tq.quant_cols_cuda(v2, n)
    assert calls == [], what
