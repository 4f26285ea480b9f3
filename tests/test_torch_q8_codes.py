"""The int8 path's row quantizations folded into the kernels that produce
their inputs (K13: ``csrc/layer_fused_q8.cu``'s ``attention_q8_kernel`` and
``gemm_q8_bias_kernel``'s codes epilogue) on the CPU.

1. The kernels' new plain twins against the JAX package in f32, on codes
   made by JAX's ``_quant_rows``: ``attention_q8_plain`` against
   ``_mha_block_q8`` then ``_quant_rows`` of its output (its codes and
   scales JAX's ``_quant_rows`` of the twin's own output bit for bit, and
   within 1 and 1e-5 of JAX's: the two outputs differ in their last f32
   bits);
   ``gemm_q8_bias_codes_plain`` against ``_quant_rows`` of each segment of
   ``_qlinear_pre``'s output (the QKV's Q and K, the cross KV's K, the
   cross Q, the FFN hidden after ReLU), at the paper, default and a ragged
   geometry. The GEMM's codes, scales and output bit for bit; the
   attention's output within 1e-5 of max |JAX| (its l and exp2 are f32
   work in another order and by another routine).
2. Each twin equal, bit for bit, to the port's own composition that it
   replaces, and the plain layers' ``codes_out`` equal to the row
   quantizer of their output.
3. The kernel route on meta tensors (the entry points recorded, nothing
   launched): a layer handed its inputs' codes launches no row quantizer;
   ``engine.forward``'s int8 layers, at the paper's layer counts, launch it
   exactly 3 times, and each GEMM and attention entry point is handed its
   codes-out pointers as the fold table of ``ops/layer_fused_q8.py``
   says; the tile choice of the codes epilogue (``codes_tile``).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu.ops import layer_fused_q8 as jq
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.config import Config, InputConfig, ModelConfig
from nylon_amt_tpu_torch.infer import engine as tengine
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_q8 as tq
from nylon_amt_tpu_torch.ops.precision import full_f32

M = 203            # not a multiple of the 128-row tiles
# (hid, pf): the paper's, the default model's, and a ragged geometry
WIDTHS = {"paper": (256, 512), "default": (64, 128), "ragged": (96, 160)}
TOL = 1e-5         # f32 outputs, of max(1, max |JAX|)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- plain twins vs JAX --

@pytest.mark.parametrize("n,lq,lk,hid,heads", [
    (2, 24, 24, 64, 2),      # the default widths' head_dim 32, self
    (2, 11, 40, 96, 3),      # hid 96 over 3 heads, cross (Lq != Lk)
    (1, 16, 32, 256, 4),     # the paper's head_dim 64
])
def test_attention_plain_matches_jax_f32(n, lq, lk, hid, heads):
    rng = np.random.default_rng(lq + lk + hid)
    q, k, v = (rng.standard_normal((n, ln, hid)).astype(np.float32)
               for ln in (lq, lk, lk))
    scale = 1.0 / float(hid // heads) ** 0.5
    want = jq._mha_block_q8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            heads, scale)
    want_q, want_s = jq._quant_rows(want)
    qq, sq = jq._quant_rows(jnp.asarray(q))
    kq, sk = jq._quant_rows(jnp.asarray(k))
    # V per column over the keys, as _mha_block_q8 quantizes it
    av = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(v)), axis=1,
                             keepdims=True), 1e-12)
    vq = jnp.round(v * (127.0 / av)).astype(jnp.int32).astype(jnp.int8)
    sv = av * (1.0 / (127.0 * 127.0))
    with full_f32():
        out, codes, scales = tq.attention_q8_plain(
            _t(qq), _t(sq), _t(kq), _t(sk), _t(vq), _t(sv), heads, scale,
            torch.float32)
    top = max(1.0, float(np.abs(np.array(want)).max()))
    assert (out - _t(want)).abs().max().item() <= TOL * top
    # the twin's codes and scales: JAX's _quant_rows of the twin's own
    # output, bit for bit; against JAX's whole pipeline, whose output
    # differs from the twin's in the last f32 bits (l and exp2), the scales
    # within TOL and the codes within 1
    own_q, own_s = jq._quant_rows(jnp.asarray(out.numpy()))
    assert torch.equal(codes, _t(own_q)) and torch.equal(scales, _t(own_s))
    assert ((scales - _t(want_s)).abs() <= TOL * _t(want_s)).all()
    assert (codes.int() - _t(want_q).int()).abs().max().item() <= 1


# (k, n, seg, n_seg, relu) of each fold of the bias GEMM's codes epilogue
def _fold(what, hid, pf):
    return {"qkv": (hid, 3 * hid, hid, 2, False),
            "kv": (hid, 2 * hid, hid, 1, False),
            "q": (hid, hid, hid, 1, False),
            "w1": (hid, pf, pf, 1, True)}[what]


@pytest.mark.parametrize("geo", list(WIDTHS))
@pytest.mark.parametrize("what", ["qkv", "kv", "q", "w1"])
def test_gemm_codes_plain_matches_jax_f32(geo, what):
    hid, pf = WIDTHS[geo]
    k, n, seg, n_seg, relu = _fold(what, hid, pf)
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((M, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    xq, sx = jq._quant_rows(jnp.asarray(x))
    wq, sw = jq.quantize_weight(jnp.asarray(w))
    y = jq._qlinear_pre(xq, sx, wq, sw, jnp.asarray(b), jnp.float32)
    if relu:
        y = jnp.maximum(y, 0)
    quant = [jq._quant_rows(y[:, i * seg:(i + 1) * seg])
             for i in range(n_seg)]
    out, codes, scales = tq.gemm_q8_bias_codes_plain(
        _t(xq), _t(sx)[:, 0], _t(wq), _t(sw), _t(b), relu, seg, n_seg)
    assert torch.equal(out, _t(y))
    assert torch.equal(codes, torch.cat([_t(q) for q, _ in quant], dim=1))
    assert torch.equal(scales, torch.stack([_t(s)[:, 0] for _, s in quant]))


# ------------------------------------------ twins as the compositions --

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_twins_are_the_compositions_they_replace(dt):
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((2, ln, 96), generator=g).to(dt)
               for ln in (20, 33, 33))
    scale = tlf._scale(96, 3)
    qq, sq = tq._quant_rows(q)
    kq, sk = tq._quant_rows(k)
    vq, sv = tq._quant_cols(v)
    with full_f32():
        out, codes, scales = tq.attention_q8_plain(qq, sq, kq, sk, vq, sv, 3,
                                                   scale, dt)
        heads = tq._mha_block_q8(q, k, v, 3, scale)
    assert torch.equal(out, heads)
    oq, os_ = tq._quant_rows(heads)
    assert torch.equal(codes, oq) and torch.equal(scales, os_)

    aq, sa = tq._quant_rows(torch.randn((M, 96), generator=g).to(dt))
    wq, sw = tq.quantize_weight(torch.randn((96, 288), generator=g) / 10)
    bias = torch.randn(288, generator=g).to(dt)
    got = tq.gemm_q8_bias_codes_plain(aq, sa[:, 0], wq, sw, bias, False, 96,
                                      2)
    plain = tq.gemm_q8_bias_plain(aq, sa[:, 0], wq, sw, bias)
    assert torch.equal(got[0], plain)
    for i in range(2):
        pq, ps = tq._quant_rows(plain[:, 96 * i:96 * (i + 1)])
        assert torch.equal(got[1][:, 96 * i:96 * (i + 1)], pq)
        assert torch.equal(got[2][i], ps[:, 0])


def _params(kind, hid, pf, rng, dt=torch.float32, device="cpu"):
    """Seeded int8 params of one layer (``dec_zero``: no self-attention)."""
    shapes = tlf.weight_shapes(hid, pf)
    cls = tlf.EncoderLayerParams if kind == "enc" else tlf.CrossLayerParams
    if kind == "dec_zero":
        shapes = dict(shapes, wsqkv=(hid, 0), bsqkv=(0,))

    def make(f):
        t = torch.from_numpy(
            (rng.standard_normal(shapes[f]) / math.sqrt(hid)).astype(
                np.float32))
        if f == "g":
            t = t + 1.0
        return t.to(torch.float32 if f in ("g", "b") else dt).to(device)
    p = cls(**{f: make(f) for f in cls._fields})
    return (tq.quantize_encoder_params if kind == "enc"
            else tq.quantize_cross_params)(p)


@pytest.mark.parametrize("kind", ["enc", "dec_zero", "dec"])
def test_cpu_layers_codes_out_are_the_row_quantizer_of_their_output(kind):
    hid, pf, heads, n = 32, 64, 2, 2
    rng = np.random.default_rng(11)
    p = _params(kind, hid, pf, rng)
    x = torch.from_numpy(rng.standard_normal((n, 12, hid)).astype(np.float32))
    enc = torch.from_numpy(rng.standard_normal((n, 20, hid))
                           .astype(np.float32))
    bogus = (torch.zeros((n * 12, hid), dtype=torch.int8),
             torch.ones(n * 12))
    if kind == "enc":
        plain = tq.encoder_layer_q8(x, p, heads)
        got = tq.encoder_layer_q8(x, p, heads, x_codes=bogus, codes_out=True)
    else:
        fn = tq.decoder_layer_zero_q8 if kind == "dec_zero" \
            else tq.decoder_layer_q8
        plain = fn(x, enc, p, heads)
        got = fn(x, enc, p, heads, trg_codes=bogus, codes_out=True)
    out, q, s = got
    assert torch.equal(out, plain)       # the plain path quantizes itself
    wq, ws = tq._quant_rows(plain)
    assert torch.equal(q, wq.reshape(-1, hid))
    assert torch.equal(s, ws.reshape(-1))


# ----------------------------------------------- the route on meta tensors --

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


def _meta_params(kind, hid, pf):
    """A layer's int8 params on the meta device and their K-major packs."""
    shapes = tlf.weight_shapes(hid, pf)
    if kind == "dec_zero":
        shapes = dict(shapes, wsqkv=(hid, 0), bsqkv=(0,))
    cls = tlf.EncoderLayerParams if kind == "enc" else tlf.CrossLayerParams

    def z(f):
        dt = torch.float32 if f in ("g", "b") else torch.bfloat16
        return torch.zeros(shapes[f], dtype=dt, device="meta")
    p = cls(**{f: z(f) for f in cls._fields})
    p = (tq.quantize_encoder_params if kind == "enc"
         else tq.quantize_cross_params)(p)
    return p, tq.pack_wt(p)


def _summary(calls):
    """Each recorded call as (kind, its codes pointers): present (0 on
    meta) or absent (None)."""
    out = []
    for name, a in calls:
        if "q8_gemm_bias" in name:       # out, q; seg, n_seg; relu
            out.append(("bias", a[5] is not None, a[6] is not None, a[12],
                        a[13], a[11]))
        elif "q8_gemm_res_ln" in name:   # q_out
            out.append(("ln", a[9] is not None))
        elif "q8_attention" in name:     # codes, o
            out.append(("attn", a[9] is not None, a[11] is not None))
        elif "q8_quant_rows" in name:
            out.append(("rows",))
        elif "q8_quant_cols" in name:
            out.append(("cols",))
        else:
            out.append((name,))
    return out


def _layer_route(kind, hid, pf, x_codes, enc_codes, codes_out):
    """The calls a layer makes, as _summary gives them: the fold table."""
    rows = [("rows",)] * (not x_codes)
    enc_rows = [("rows",)] * (not enc_codes)
    qkv = [("bias", True, True, hid, 2, 0), ("cols",), ("attn", True, False)]
    tail = [("ln", True), ("bias", False, True, pf, 1, 1), ("ln", codes_out)]
    cross = [("bias", False, True, hid, 1, 0), ("bias", True, True, hid, 1, 0),
             ("cols",), ("attn", True, False)]
    if kind == "enc":
        return rows + qkv + tail
    if kind == "dec_zero":
        return rows + enc_rows + cross + tail
    return rows + qkv + [("ln", True)] + enc_rows + cross + tail


@pytest.mark.parametrize("kind", ["enc", "dec_zero", "dec"])
@pytest.mark.parametrize("handed", [False, True])
def test_q8_layer_handed_its_input_codes_quantizes_nothing(calls, kind,
                                                            handed):
    hid, pf, heads, n = 64, 128, 2, 2
    p, wt = _meta_params(kind, hid, pf)
    x = torch.empty((n, 88, hid), dtype=torch.bfloat16, device="meta")
    enc = torch.empty((n, 256, hid), dtype=torch.bfloat16, device="meta")

    def codes(rows):
        return (torch.empty((rows, hid), dtype=torch.int8, device="meta"),
                torch.empty((rows,), dtype=torch.float32, device="meta"))
    if kind == "enc":
        got = tq.encoder_layer_q8(x, p, heads, wt=wt, codes_out=True,
                                  x_codes=codes(n * 88) if handed else None)
    else:
        fn = tq.decoder_layer_zero_q8 if kind == "dec_zero" \
            else tq.decoder_layer_q8
        got = fn(x, enc, p, heads, wt=wt, codes_out=True,
                 trg_codes=codes(n * 88) if handed else None,
                 enc_codes=codes(n * 256) if handed else None)
    assert [tuple(t.shape) for t in got] == [(n, 88, hid), (n * 88, hid),
                                             (n * 88,)]
    assert _summary(calls) == _layer_route(kind, hid, pf, handed, handed,
                                           True)


def test_engine_int8_forward_quantizes_three_inputs(calls):
    """The paper's layer counts (3 frequency encoder, 3 decoder, 3 time
    layers) at small widths: the stem's output, the decoder's note queries
    and the first time layer's input are the only inputs the row quantizer
    sees; every other layer takes the codes its predecessor's last kernel
    wrote."""
    hid, pf, heads, n_frame, n_bin, B = 64, 128, 2, 8, 16, 2
    cfg = Config(model=ModelConfig(hid_dim=hid, pf_dim=pf, enc_layer=3,
                                   dec_layer=3, enc_head=heads,
                                   dec_head=heads,
                                   compute_dtype="bfloat16"),
                 input=InputConfig(num_frame=n_frame))
    n_note = cfg.midi.num_note
    meta = dict(device="meta")

    def layers(kind, count):
        return [_meta_params(kind, hid, pf) for _ in range(count)]
    enc, dec, time_ = layers("enc", 3), layers("dec", 2), layers("enc", 3)
    dec_zero = _meta_params("dec_zero", hid, pf)
    heads_ = {k: (torch.zeros((hid, 1), dtype=torch.bfloat16, **meta),
                  torch.zeros((1,), dtype=torch.bfloat16, **meta))
              for k in ("onset", "offset", "mpe", "velocity")}
    packed = tengine.PackedHFT(
        dtype=torch.bfloat16,
        k_eff=torch.zeros((65, hid), **meta), b_eff=torch.zeros(hid, **meta),
        pos_freq=torch.zeros((n_bin, hid), dtype=torch.bfloat16, **meta),
        enc=[p for p, _ in enc],
        note_q=torch.zeros((n_note, hid), dtype=torch.bfloat16, **meta),
        dec_zero=dec_zero[0], dec=[p for p, _ in dec], heads_a=heads_,
        pos_time=torch.zeros((n_frame, hid), dtype=torch.bfloat16, **meta),
        time=[p for p, _ in time_], heads_b=heads_, precision="int8",
        wt={"enc": [w for _, w in enc], "dec_zero": dec_zero[1],
            "dec": [w for _, w in dec], "time": [w for _, w in time_]})
    spec = torch.zeros((B, n_bin, cfg.input.margin_b + n_frame
                        + cfg.input.margin_f), **meta)
    out = tengine.forward(packed, spec, cfg)
    assert out["onset_A"].shape == (B, n_frame, n_note)
    got = _summary(calls)
    assert got.count(("rows",)) == 3
    want = [("nylon_stem_embed",)]
    for i in range(3):                  # each hands its codes on
        want += _layer_route("enc", hid, pf, i > 0, True, True)
    want += _layer_route("dec_zero", hid, pf, False, True, True)
    for i in range(2):                  # the last one hands none
        want += _layer_route("dec", hid, pf, True, True, i == 0)
    for i in range(3):
        want += _layer_route("enc", hid, pf, i > 0, True, i < 2)
    assert got == want


@pytest.mark.parametrize("n,seg,n_seg,codes_only,tile", [
    (768, 256, 2, False, 256),    # the paper's QKV: Q and K
    (192, 64, 2, False, 192),     # the default widths' QKV
    (288, 96, 2, False, 192),     # hid 96: Q and K in the first tile
    (384, 128, 2, False, 256),    # hid 128: K would straddle a 192 tile
    (480, 160, 2, False, 0),      # hid 160: no tile holds K
    (512, 256, 1, False, 256),    # the paper's cross KV: K
    (256, 256, 1, True, 256),     # the paper's cross Q
    (512, 512, 1, True, 256),     # the paper's FFN hidden: two tiles
    (160, 160, 1, True, 192),     # pf 160
    (1024, 1024, 1, True, 0),     # wider than two tiles
    (96, 32, 2, False, 0),        # segments narrower than 64
])
def test_codes_tile_states_the_epilogues_constraints(n, seg, n_seg,
                                                     codes_only, tile):
    assert tq.codes_tile(n, seg, n_seg, codes_only) == tile
