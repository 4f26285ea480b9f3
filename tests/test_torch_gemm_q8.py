"""The int8 layer GEMMs of the port (``csrc/layer_fused_q8.cu``'s
``gemm_q8_bias_kernel`` and ``gemm_q8_res_ln_kernel``: s8 ``wgmma`` fed by
TMA) on the CPU.

1. The K-major weight pack, :func:`layer_fused_q8.pack_wt`, is bit for bit
   the transpose of JAX's ``quantize_weight`` codes, for every weight
   matrix of both parameter types in f32 and bf16, layer zero's zero-size
   self-attention placeholder included.
2. The kernels' named plain twins (``gemm_q8_bias_plain``,
   ``gemm_q8_res_ln_plain`` with ``quant_out``) against JAX's
   ``_qlinear_pre`` (then ``_layer_norm`` and ``_quant_rows`` of the
   output) on seeded numpy codes, at the paper, default and a ragged
   geometry (hid 96, pf 160, M not a multiple of 128): the GEMM + bias bit
   for bit; the LayerNorm output within 1e-6 (f32) or one bf16 ulp of its
   largest value (bf16: the statistics are f32 sums in another order); the
   twin's output codes and scales JAX's ``_quant_rows`` of the twin's own
   output, bit for bit. bf16 runs JAX in a child interpreter without XLA's
   excess precision, at one geometry a product (all three among them).
3. The wrappers hand the kernels the K-major pack, refuse a missing pack
   or one of another shape, dtype or layout; the layers refuse to run
   without their packs; the shapes the C
   entry points refuse are refused before the loader, and
   ``check_geometry`` states the layers' own constraints.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nylon_amt_tpu.ops import layer_fused as jlf
from nylon_amt_tpu.ops import layer_fused_q8 as jq
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_q8 as tq

HERE = Path(__file__).resolve().parent
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
M = 203            # not a multiple of the 128-row tiles
# (hid, pf): the paper's, the default model's, and a ragged geometry
WIDTHS = {"paper": (256, 512), "default": (64, 128), "ragged": (96, 160)}
LN_TOL_F32 = 1e-6  # LayerNorm output vs JAX's, f32 (of max(1, max |JAX|))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (many small ops; the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the pack --

def _q8_params(kind, dt, hid=32, pf=64):
    """JAX's and the port's int8 packs of one layer's seeded weights at
    ``dt`` (dec_zero: JAX's zero-size self-attention placeholders)."""
    if kind == "enc":
        cls_j, cls_t = jlf.EncoderLayerParams, tlf.EncoderLayerParams
        quant_j, quant_t = (jq.quantize_encoder_params,
                            tq.quantize_encoder_params)
    else:
        cls_j, cls_t = jlf.CrossLayerParams, tlf.CrossLayerParams
        quant_j, quant_t = jq.quantize_cross_params, tq.quantize_cross_params
    shapes = tlf.weight_shapes(hid, pf)
    if kind == "dec_zero":
        shapes = dict(shapes, wsqkv=(hid, 0), bsqkv=(0,))
    rng = np.random.default_rng(11)
    pj, pt = {}, {}
    for f in cls_j._fields:
        f32 = f in ("g", "b")
        pj[f] = jnp.asarray(rng.standard_normal(shapes[f]), jnp.float32
                            ).astype(jnp.float32 if f32 else _JDT[dt])
        pt[f] = torch.from_numpy(np.array(pj[f].astype(jnp.float32))).to(
            torch.float32 if f32 else _TDT[dt])
    return quant_j(cls_j(**pj)), quant_t(cls_t(**pt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["enc", "dec", "dec_zero"])
def test_pack_wt_is_the_transpose_of_jax_codes(kind, dt):
    pj, pt = _q8_params(kind, dt)
    wt = tq.pack_wt(pt)
    mats = [f for f, a in zip(pj._fields, pj)
            if a.dtype == jnp.int8 and a.size]
    assert sorted(wt) == sorted(mats)
    if kind != "enc":
        assert ("wsqkv" in wt) == (kind == "dec")
    for f in mats:
        got = wt[f]
        assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(pj, f)).T,
                                      err_msg=f"{kind} {f}")
        assert got.data_ptr() % 16 == 0
    # one buffer: the views tile it in field order
    ptrs = [wt[f].data_ptr() for f in mats]
    sizes = [wt[f].numel() for f in mats]
    assert all(b - a == s for a, b, s in zip(ptrs, ptrs[1:], sizes))


def test_engine_packs_wt_on_the_card_only():
    """A CPU int8 pack holds no K-major pack: the plain versions read the
    codes ``[K, N]``."""
    from nylon_amt_tpu_torch.config import Config, ModelConfig
    from nylon_amt_tpu_torch.infer import engine as tengine
    from nylon_amt_tpu_torch.models.hft import HFT

    cfg = Config(model=ModelConfig(hid_dim=32, pf_dim=64, enc_layer=2,
                                   dec_layer=2, enc_head=2, dec_head=2))
    for dt in (torch.float32, torch.bfloat16):
        packed = tengine.pack_params(HFT(cfg, "cpu").eval(), dt,
                                     precision="int8")
        assert packed.precision == "int8"
        assert packed.wt is None and packed.tf32 is None


# ------------------------------------------------ the plain twins vs JAX --

def _products(hid, pf):
    """(name, kernel, K, N, relu, quant_out) of an int8 layer's GEMMs."""
    return [("qkv", "bias", hid, 3 * hid, 0, 0),
            ("ffn1", "bias", hid, pf, 1, 0),
            ("o", "ln", hid, hid, 0, 1), ("ffn2", "ln", pf, hid, 0, 0)]


@jax.jit
def _jax_codes(x, w):
    """JAX's codes and scales of x and w and ``_qlinear_pre``'s dequantized
    product ``f32(acc) * sx * sw``, in one compiled call (no add follows the
    products in it, so XLA cannot contract them into an FMA)."""
    xq, sx = jq._quant_rows(x)
    wq, sw = jq.quantize_weight(w)
    return xq, sx, wq, sw, jq._qdot(xq, wq).astype(jnp.float32) * sx * sw


@functools.partial(jax.jit, static_argnames=("relu", "ln"))
def _jax_rest(y, bias, res, g, b, relu, ln):
    """The rest of ``_qlinear_pre`` on its product ``y`` (the cast, then the
    bias add in the bias's dtype), then ReLU or the residual + LayerNorm,
    in one compiled call: ``y`` comes in computed, so no product feeds the
    bias add. Returns (``_qlinear_pre``'s output, the GEMM's)."""
    pre = y.astype(bias.dtype) + bias
    out = jnp.maximum(pre, 0) if relu else pre
    return pre, jlf._layer_norm(res + out, g, b) if ln else out


_jax_quant_rows = jax.jit(jq._quant_rows)


def _twin_case(geo, name, dt):
    """(JAX, port) results of one product's plain twin at ``dt``, as f32
    numpy: ``[out]`` for the GEMM + bias, ``[out, codes of out, scales of
    out, JAX's codes and scales of the port's out]`` for the LayerNorm
    GEMM."""
    hid, pf = WIDTHS[geo]
    _, kern, k, n, relu, quant_out = next(
        p for p in _products(hid, pf) if p[0] == name)
    rng = np.random.default_rng(CASES.index((geo, name)))
    jdt, tdt = _JDT[dt], _TDT[dt]
    x = jnp.asarray(rng.standard_normal((M, k)), jnp.float32).astype(jdt)
    w = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k),
                    jnp.float32).astype(jdt)
    bias = jnp.asarray(0.1 * rng.standard_normal(n), jnp.float32).astype(jdt)
    res = jnp.asarray(rng.standard_normal((M, n)), jnp.float32).astype(jdt)
    g = jnp.asarray(1.0 + 0.1 * rng.standard_normal(n), jnp.float32)
    b = jnp.asarray(0.1 * rng.standard_normal(n), jnp.float32)
    xq, sx, wq, sw, y = _jax_codes(x, w)
    pre, out_j = _jax_rest(y, bias, res, g, b, relu=bool(relu),
                           ln=kern == "ln")
    np.testing.assert_array_equal(   # the compiled calls are _qlinear_pre's
        np.asarray(pre.astype(jnp.float32)), np.asarray(
            jq._qlinear_pre(xq, sx, wq, sw, bias, jdt).astype(jnp.float32)))
    t = {"aq": torch.from_numpy(np.array(xq)),
         "sa": torch.from_numpy(np.array(sx)[:, 0]),
         "wq": torch.from_numpy(np.array(wq)),
         "sw": torch.from_numpy(np.array(sw)),
         "bias": torch.from_numpy(np.array(bias.astype(jnp.float32)))
         .to(tdt)}

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
            if not isinstance(a, torch.Tensor) else a.float().numpy()

    if kern == "bias":
        got_t = tq.gemm_q8_bias_plain(**t, relu=bool(relu))
        return [f32(out_j)], [f32(got_t)]
    out_t, q_t, s_t = tq.gemm_q8_res_ln_plain(
        **t, res=torch.from_numpy(np.array(res.astype(jnp.float32)))
        .to(tdt), g=torch.from_numpy(np.array(g)),
        b=torch.from_numpy(np.array(b)), quant_out=bool(quant_out))
    if not quant_out:
        assert q_t is None and s_t is None
        return [f32(out_j)], [f32(out_t)]
    # JAX's row quantizer on the twin's own output
    qj, sj = _jax_quant_rows(jnp.asarray(f32(out_t)).astype(jdt))
    return ([f32(out_j), np.asarray(qj).astype(np.float32),
             np.asarray(sj)[:, 0]],
            [f32(out_t), q_t.numpy().astype(np.float32), s_t.numpy()])


def _agreement(geo, name, dt):
    """[max |out - JAX's| over max(1, max |JAX's|), that in bf16 ulps of
    max |JAX's|, whether the codes and scales are equal (None without
    quant_out), whether the shapes agree]."""
    want, got = _twin_case(geo, name, dt)
    top = max(1.0, float(np.abs(want[0]).max()))
    d = float(np.abs(want[0] - got[0]).max())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[0]).max())) - 7)
    codes = None if len(want) == 1 else bool(
        np.array_equal(want[1], got[1]) and np.array_equal(want[2], got[2]))
    return [d / top, float(d / ulp), codes, want[0].shape == got[0].shape]


CASES = [(geo, name) for geo in WIDTHS
         for name in ("qkv", "ffn1", "o", "ffn2")]
# bf16: one geometry a product, the paper's LayerNorm GEMM with quant_out
# among them (each case costs its own JAX compiles in the child)
CASES_BF16 = [("paper", "qkv"), ("default", "ffn1"), ("paper", "o"),
              ("ragged", "ffn2")]


@pytest.mark.parametrize("geo,name", CASES)
def test_plain_twins_match_jax_f32(geo, name):
    rel, _, codes, same_shape = _agreement(geo, name, "f32")
    assert same_shape
    if name in ("qkv", "ffn1"):
        assert rel == 0.0, f"{geo} {name}: not bit-identical ({rel:.3e})"
    else:
        assert rel <= LN_TOL_F32, (geo, name, rel)
    assert codes in (None, True), f"{geo} {name}: codes differ"


@functools.lru_cache(maxsize=1)
def _bf16_rows():
    """``_agreement`` of every bf16 case, from one fresh interpreter
    (XLA's CPU compiler keeps excess precision across bf16 casts unless
    told not to; see tests/test_torch_q8.py)."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(HERE)!r})\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_gemm_q8 as t\n"
            "print(json.dumps({f'{g} {n}': t._agreement(g, n, 'bf16')"
            " for g, n in t.CASES_BF16}))\n")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("geo,name", CASES_BF16)
def test_plain_twins_match_jax_bf16(geo, name):
    rel, ulps, codes, same_shape = _bf16_rows()[f"{geo} {name}"]
    assert same_shape
    if name in ("qkv", "ffn1"):
        assert rel == 0.0, f"{geo} {name}: not bit-identical ({rel:.3e})"
    else:
        assert ulps <= 1.0, (geo, name, ulps)
    assert codes in (None, True), f"{geo} {name}: codes differ"


# ------------------------------------------------------------ wrappers --

@pytest.fixture
def calls(monkeypatch):
    """The (entry point, its arguments) of every kernel call."""
    seen = []
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return seen


def _gemm_inputs(k, n, dt=torch.float32, seed=3):
    rng = np.random.default_rng(seed)
    aq = torch.from_numpy(rng.integers(-127, 128, (M, k)).astype(np.int8))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    wq, sw = tq.quantize_weight(w)
    return dict(aq=aq, sa=torch.rand(M) + 0.01, wq=wq, sw=sw,
                bias=torch.zeros(n, dtype=dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_q8_wrappers_hand_the_kernel_the_kmajor_pack(calls, dt):
    x = _gemm_inputs(96, 160, dt)
    wt = x["wq"].t().contiguous()
    tq._gemm_q8(**x, relu=True, wt=wt)
    res, g, b = torch.zeros((M, 160), dtype=dt), torch.ones(160), \
        torch.zeros(160)
    x2 = _gemm_inputs(160, 96, dt)   # ln: N <= 256
    wt2 = x2["wq"].t().contiguous()
    res2 = res[:, :96].contiguous()
    tq._gemm_q8_res_ln(**x2, res=res2, g=g[:96], b=b[:96], quant_out=True,
                       wt=wt2)
    sfx = "" if dt == torch.bfloat16 else "_f32"
    assert [(n, a[2]) for n, a in calls] == [
        (f"nylon_q8_gemm_bias{sfx}", wt.data_ptr()),
        (f"nylon_q8_gemm_res_ln{sfx}", wt2.data_ptr())]
    # no codes (q, s null), M, N, K, relu, no segments (seg, n_seg)
    assert calls[0][1][6:14] == (None, None, M, 160, 96, 1, 0, 0)
    assert calls[1][1][11:14] == (M, 96, 160)         # M, N, K
    # a pack_wt entry: a view of the layer's buffer
    z = torch.zeros
    p = tq.quantize_encoder_params(tlf.EncoderLayerParams(
        z(96, 288), z(288), z(96, 96), z(96), z(96), z(96), z(96, 160),
        z(160), x2["wq"].float(), z(96)))
    packs = tq.pack_wt(p)
    tq._gemm_q8_res_ln(**dict(x2, wq=p.w2), res=res2, g=g[:96], b=b[:96],
                       wt=packs["w2"])
    assert calls[-1][1][2] == packs["w2"].data_ptr()
    # no pack: refused on any device, before the loader
    n_calls = len(calls)
    with pytest.raises(ValueError, match="none was given"):
        tq._gemm_q8(**x)
    assert len(calls) == n_calls


def test_q8_wrappers_refuse_another_pack(calls):
    x = _gemm_inputs(96, 160)
    wq = x["wq"]
    for bad in (wq, wq.t(), wq.t().contiguous()[:, :80],
                wq.t().contiguous().float(),
                wq.t().contiguous().to(torch.int16)):
        with pytest.raises(ValueError, match="W\\^T"):
            tq._gemm_q8(**x, wt=bad)
    assert calls == []


def test_q8_gemm_on_the_card_refuses_a_missing_pack():
    """On the card an s8 GEMM takes its weight's K-major pack or raises (the
    weight: its shape and device are all the check reads)."""
    w = SimpleNamespace(shape=(96, 160), device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="none was given"):
        tq.gemm_wt("gemm_q8_bias", w, None)
    wt = torch.zeros((160, 96), dtype=torch.int8)
    with pytest.raises(ValueError, match="W\\^T"):   # on another device
        tq.gemm_wt("gemm_q8_bias", w, wt)


@pytest.mark.parametrize("k,n,ln", [
    (100, 160, False),     # K % 16
    (1056, 160, False),    # K > 1040: f32(sum) no longer exact
    (96, 164, False),      # N % 8
    (96, 264, True),       # the LayerNorm GEMM owns rows of N <= 256
])
def test_q8_gemm_shapes_refused_before_the_loader(calls, k, n, ln):
    x = _gemm_inputs(k, n)
    with pytest.raises(ValueError, match="s8 GEMM kernels take"):
        if ln:
            tq._gemm_q8_res_ln(**x, res=torch.zeros((M, n)),
                               g=torch.ones(n), b=torch.zeros(n))
        else:
            tq._gemm_q8(**x)
    assert calls == []


@pytest.fixture
def meta_route(monkeypatch, calls):
    """Meta tensors through the int8 layers' kernel route: the device guard
    and the CUDA check stubbed, the entry points recorded."""
    import contextlib

    def check_cuda(name, t, dtype, ndim=None):
        assert t.device.type == "meta" and t.dtype == dtype, (name, t)

    monkeypatch.setattr(kernels, "check_cuda", check_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return calls


def _meta_q8(cls, hid, pf, with_self=True):
    shapes = tlf.weight_shapes(hid, pf)
    if not with_self:
        shapes = dict(shapes, wsqkv=(hid, 0), bsqkv=(0,))

    def z(f):
        dt = torch.float32 if f in ("g", "b") else torch.bfloat16
        return torch.zeros(shapes[f], dtype=dt, device="meta")
    p = cls(**{f: z(f) for f in cls._fields})
    quant = tq.quantize_encoder_params if cls is tlf.EncoderLayerParams \
        else tq.quantize_cross_params
    return quant(p)


@pytest.mark.parametrize("kind", ["enc", "dec_zero", "dec"])
def test_q8_layers_hand_their_gemms_the_packs(meta_route, kind):
    hid, pf, heads, n = 64, 128, 2, 2
    cls = tlf.EncoderLayerParams if kind == "enc" else tlf.CrossLayerParams
    p = _meta_q8(cls, hid, pf, with_self=kind != "dec_zero")
    x = torch.empty((n, 88, hid), dtype=torch.bfloat16, device="meta")
    enc = torch.empty((n, 256, hid), dtype=torch.bfloat16, device="meta")
    fn = {"enc": lambda **kw: tq.encoder_layer_q8(x, p, heads, **kw),
          "dec_zero": lambda **kw: tq.decoder_layer_zero_q8(x, enc, p, heads,
                                                            **kw),
          "dec": lambda **kw: tq.decoder_layer_q8(x, enc, p, heads, **kw)}
    order = {"enc": ["wqkv", "wo", "w1", "w2"],
             "dec_zero": ["wq", "wkv", "wo", "w1", "w2"],
             "dec": ["wsqkv", "wso", "wq", "wkv", "wo", "w1", "w2"]}[kind]
    bias, ln = "nylon_q8_gemm_bias", "nylon_q8_gemm_res_ln"
    kinds = {"wqkv": bias, "wsqkv": bias, "wq": bias, "wkv": bias,
             "w1": bias, "wo": ln, "wso": ln, "w2": ln}
    # each GEMM in the layer's order, its pack checked by shape (gemm_wt)
    wt = tq.pack_wt(p)
    fn[kind](wt=wt)
    gemms = [args for name, args in meta_route if "gemm" in name]
    assert [name for name, _ in meta_route if "gemm" in name] == [
        kinds[f] for f in order]
    # and each reads its own matrix's pack
    assert [a[2] for a in gemms] == [wt[f].data_ptr() for f in order]


def test_q8_layers_on_the_card_refuse_missing_packs():
    """A layer takes its weights' K-major packs or raises."""
    p = _meta_q8(tlf.EncoderLayerParams, 64, 128)
    fields = ("wqkv", "sqkv", "bqkv") + tq._FFN_LN
    with pytest.raises(ValueError, match="pack_wt"):
        tq.layer_wt("encoder_layer_q8", fields, None)
    partial = {k: v for k, v in tq.pack_wt(p).items() if k != "w2"}
    with pytest.raises(ValueError, match="'w2'"):
        tq.layer_wt("encoder_layer_q8", fields, partial)
    wt = tq.pack_wt(p)
    assert tq.layer_wt("encoder_layer_q8", fields, wt) is wt


@pytest.mark.parametrize("hid,heads,pf,lk,ok", [
    (256, 4, 512, 256, True),     # the paper's
    (64, 2, 128, 256, True),      # the default model's
    (64, 2, 160, 256, True),      # pf % 16: the GEMMs' K
    (128, 2, 1024, 88, True),
    (96, 3, 160, 256, True),      # a ragged column block of V's quantizer
    (64, 2, 168, 256, False),     # pf % 16
    (64, 2, 1040, 256, False),    # pf > 1024: the row quantizer
    (320, 5, 512, 256, False),    # hid > 256: the LayerNorm epilogue
    (192, 4, 512, 256, False),    # head_dim 48
    (64, 2, 128, 257, False),     # > 256 keys
    (64, 2, 128, 90, False),      # keys % 4: the key scales' 16-byte copy
])
def test_check_geometry_states_the_kernels_constraints(hid, heads, pf, lk,
                                                       ok):
    if ok:
        tq.check_geometry("x", hid, heads, pf, lk)
    else:
        with pytest.raises(ValueError, match="kernels need"):
            tq.check_geometry("x", hid, heads, pf, lk)
