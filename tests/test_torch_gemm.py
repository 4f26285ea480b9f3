"""The bf16 layer GEMMs of the port (``csrc/layer_fused.cu``'s
``gemm_bias_kernel`` and ``gemm_res_ln_kernel``) on the CPU: their plain
twins and the checks their wrappers make before the kernel library loads.

1. ``gemm_bias_plain`` and ``gemm_res_ln_plain``, with and without a
   dropout site, against the JAX package's ``_matmul`` / ``_layer_norm``
   and ``hash_keep_mask`` on seeded numpy inputs: f32 within 2e-6; bf16 by
   ``tests/test_torch_layer_fused.py``'s gate (the port's error from the f32
   truth within twice JAX's + 1e-3), JAX run in a fresh interpreter without
   XLA's excess precision so that it rounds where its code casts.
2. Every plain layer (K3-K5, and the K7 training forward with its dropout
   sites) is its composition from these twins and the plain attention, bit
   for bit, in f32 and bf16: what ``chip_smoke.py`` (o) holds the kernels
   to is what (c) and (h) hold the layers to.
3. The wrappers refuse with ``ValueError``, before the library is loaded,
   what the C entry points refuse (bf16: K % 32, N % 8; f32: K % 4, N % 4;
   the LayerNorm GEMM N > 256), and take every (M, K, N) that the paper,
   default and hid-96 / pf-160 widths feed, forward and training.

And a static check of the ctypes binding: every name in
``kernels._SIGNATURES`` has one ``extern "C"`` definition in ``csrc/*.cu``
with as many parameters.
"""

import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu.ops import attention as jatt
from nylon_amt_tpu.ops import layer_fused as jlf
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import attention as tatt
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

HERE = Path(__file__).resolve().parent
M, K, SEED, RATE, TAG = 40, 64, 24_680, 0.1, 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (many small ops; the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_values(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _inputs(n, seed):
    """a [M, K], w [K, n], bias, res [M, n] (bf16 values), gamma, beta."""
    rng = np.random.default_rng(seed)
    return dict(a=_bf16_values(rng.standard_normal((M, K))),
                w=_bf16_values(rng.standard_normal((K, n)) / np.sqrt(K)),
                bias=_bf16_values(0.1 * rng.standard_normal(n)),
                res=_bf16_values(rng.standard_normal((M, n))),
                g=(1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32),
                b=(0.1 * rng.standard_normal(n)).astype(np.float32))


# (kernel, N, ReLU, dropout): N 256 draws packed 16-bit masks, N 96 not
TWIN_CASES = [(kind, n, relu, drop)
              for kind, relu in (("bias", False), ("bias", True),
                                 ("res_ln", False))
              for n in (96, 256) for drop in (False, True)]


def _jax_twin(kind, x, n, relu, drop, dtype_name):
    """The JAX package's functions on the inputs: ``[out]`` or ``[out,
    pre]`` as f32 numpy."""
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    y = jlf._matmul(jnp.asarray(x["a"]).astype(dt),
                    jnp.asarray(x["w"]).astype(dt),
                    jnp.asarray(x["bias"]).astype(dt))
    if relu:
        y = jnp.maximum(y, 0)
    if drop:
        y = y * jatt.hash_keep_mask(jnp.int32(SEED), TAG, 0, (1, M, n), RATE,
                                    dt)[0]
    if kind == "bias":
        outs = [y]
    else:
        pre = jnp.asarray(x["res"]).astype(dt) + y
        outs = [jlf._layer_norm(pre, jnp.asarray(x["g"]),
                                jnp.asarray(x["b"])), pre]
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


def _port_twin(kind, x, n, relu, drop, dtype_name):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    site = tlt._site(SEED, TAG, n, RATE, dt) if drop else None
    if kind == "bias":
        outs = [tlf.gemm_bias_plain(t["a"].to(dt), t["w"].to(dt),
                                    t["bias"].to(dt), relu, site)]
    else:
        outs = list(tlf.gemm_res_ln_plain(
            t["a"].to(dt), t["w"].to(dt), t["bias"].to(dt), t["res"].to(dt),
            t["g"], t["b"], site))
    return [o.float().numpy() for o in outs]


@pytest.mark.parametrize("kind,n,relu,drop", TWIN_CASES)
def test_gemm_twin_matches_jax_f32(kind, n, relu, drop):
    x = _inputs(n, seed=n + 2 * relu + drop)
    got = _port_twin(kind, x, n, relu, drop, "f32")
    want = _jax_twin(kind, x, n, relu, drop, "f32")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-6, rtol=2e-6)
    if drop:  # the site's mask changed the result
        assert not np.allclose(got[0], _port_twin(kind, x, n, relu, False,
                                                  "f32")[0])


def _bf16_gate_errors():
    """``{case: (port error, JAX error)}`` from the f32 truth, at bf16, for
    every output of every twin case; errors relative to max(|truth|, 1)."""
    rows = {}
    for case in TWIN_CASES:
        kind, n, relu, drop = case
        x = _inputs(n, seed=n + 2 * relu + drop)
        truth = _jax_twin(kind, x, n, relu, drop, "f32")
        j16 = _jax_twin(kind, x, n, relu, drop, "bf16")
        t16 = _port_twin(kind, x, n, relu, drop, "bf16")
        for i, ref in enumerate(truth):
            scale = np.maximum(np.abs(ref), 1.0)
            rows[f"{case}-{i}"] = (
                float(np.max(np.abs(t16[i] - ref) / scale)),
                float(np.max(np.abs(j16[i] - ref) / scale)))
    return rows


@functools.lru_cache(maxsize=1)
def _bf16_gate_rows():
    """``_bf16_gate_errors`` from a fresh interpreter with XLA's excess
    precision off (as ``tests/test_torch_layer_fused_train.py`` runs its
    gate), where JAX rounds where its code casts."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(HERE)!r})\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_gemm as t\n"
            "print(json.dumps(t._bf16_gate_errors()))\n")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind,n,relu,drop", TWIN_CASES)
def test_gemm_twin_bf16_gate(kind, n, relu, drop):
    rows = {k: v for k, v in _bf16_gate_rows().items()
            if k.startswith(f"{(kind, n, relu, drop)}-")}
    assert len(rows) == (1 if kind == "bias" else 2)
    for name, (e_port, e_jax) in rows.items():
        assert e_port <= 2.0 * e_jax + 1e-3, (name, e_port, e_jax)


# --------------------------------------------- the layers from the twins --

HID, PF, HEADS, N_SEQ = 32, 96, 2, 2


def _layer_params(cls, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = tlf.weight_shapes(HID, PF)
    out = {}
    for f in cls._fields:
        shape = shapes[f]
        if f == "g":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif f == "b":
            a = 0.1 * rng.standard_normal(shape)
        elif f.startswith("w"):
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            a = 0.1 * rng.standard_normal(shape)
        t = torch.from_numpy(_bf16_values(a))
        out[f] = t if f in ("g", "b") or dtype is None else t.to(dtype)
    return cls(**out)


def _acts(dtype, seed, *lengths):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(_bf16_values(rng.standard_normal(
        (N_SEQ, n, HID)))).to(dtype) for n in lengths]


def _attend(q, k, v):
    return tlf._mha_block(q, k, v, HEADS, tlf._scale(HID, HEADS))


def _tail(trg, enc, p):
    """The cross tail from the twins (``_cross_tail``)."""
    q = tlf.gemm_bias_plain(trg, p.wq, p.bq)
    k, v = tlf.gemm_bias_plain(enc, p.wkv, p.bkv).split(HID, dim=-1)
    y, _ = tlf.gemm_res_ln_plain(_attend(q, k, v), p.wo, p.bo, trg, p.g,
                                 p.b)
    h = tlf.gemm_bias_plain(y, p.w1, p.b1, relu=True)
    return tlf.gemm_res_ln_plain(h, p.w2, p.b2, y, p.g, p.b)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["enc", "dec_zero", "dec"])
def test_plain_layer_is_its_twins_composition(kind, dtype):
    if kind == "enc":
        p = _layer_params(tlf.EncoderLayerParams, dtype, 1)
        (x,) = _acts(dtype, 2, 48)
        q, k, v = tlf.gemm_bias_plain(x, p.wqkv, p.bqkv).split(HID, dim=-1)
        y, _ = tlf.gemm_res_ln_plain(_attend(q, k, v), p.wo, p.bo, x, p.g,
                                     p.b)
        h = tlf.gemm_bias_plain(y, p.w1, p.b1, relu=True)
        got = tlf.gemm_res_ln_plain(h, p.w2, p.b2, y, p.g, p.b)[0]
        want = tlf.encoder_layer_plain(x, p, HEADS)
    else:
        p = _layer_params(tlf.CrossLayerParams, dtype, 3)
        trg, enc = _acts(dtype, 4, 20, 48)
        if kind == "dec_zero":
            got = _tail(trg, enc, p)
            want = tlf.decoder_layer_zero_plain(trg, enc, p, HEADS)
        else:
            q, k, v = tlf.gemm_bias_plain(trg, p.wsqkv, p.bsqkv).split(
                HID, dim=-1)
            t1, _ = tlf.gemm_res_ln_plain(_attend(q, k, v), p.wso, p.bso,
                                          trg, p.g, p.b)
            got = _tail(t1, enc, p)
            want = tlf.decoder_layer_plain(trg, enc, p, HEADS)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_forward_is_its_twins_composition(dtype):
    """K7's plain training forward (dropout 0.1 at every site) from the
    twins with the kernels' sites and the plain masked attention."""
    p = _layer_params(tlf.EncoderLayerParams, None, 5)
    (x,) = _acts(dtype, 6, 48)
    c = {f: getattr(p, f).to(dtype) for f in p._fields}
    drop = tlt._drop_fn(SEED, RATE, x.device)
    qkv = tlf.gemm_bias_plain(x, c["wqkv"], c["bqkv"])
    heads = tlt._heads_fwd(qkv, HEADS, tlf._scale(HID, HEADS), True, drop)
    y, _ = tlf.gemm_res_ln_plain(
        heads, c["wo"], c["bo"], x, p.g, p.b,
        tlt._site(SEED, tlt._SITE_ATTN_OUT, HID, RATE, dtype))
    mid = tlf.gemm_bias_plain(
        y, c["w1"], c["b1"], True,
        tlt._site(SEED, tlt._SITE_FFN_MID, PF, RATE, dtype))
    got, _ = tlf.gemm_res_ln_plain(
        mid, c["w2"], c["b2"], y, p.g, p.b,
        tlt._site(SEED, tlt._SITE_FFN_OUT, HID, RATE, dtype))
    want = tlt._enc_fwd_body(x, p, SEED, HEADS, RATE, False)
    assert torch.equal(got, want)


# ------------------------------------------------ the wrappers' checks --

class _Loader(Exception):
    """Raised where the kernel library would load."""


@pytest.fixture
def no_loader(monkeypatch):
    def load():
        raise _Loader

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)


def _site_or_none(drop, n, dtype):
    return tlt._site(SEED, TAG, n, RATE, dtype) if drop else None


def _call(wrapper, m, k, n, dtype, drop=False, pre=False, out=True):
    a = torch.zeros((m, k), dtype=dtype)
    w = torch.zeros((k, n), dtype=dtype)
    bias = torch.zeros(n, dtype=dtype)
    if wrapper == "bias":
        return tlt._gemm_bias(a, w, bias, True, _site_or_none(drop, n, dtype))
    res = torch.zeros((m, n), dtype=dtype)
    g, b = torch.ones(n), torch.zeros(n)
    if wrapper == "res_ln" and not (drop or pre):
        return tlf._gemm_res_ln(a, w, bias, res, g, b)
    return tlt._gemm_res_ln(a, w, bias, res, g, b,
                            _site_or_none(drop, n, dtype), pre=pre, out=out)


REFUSED = [  # (wrapper, K, N, dtype): what the C entry points refuse
    ("bias", 48, 256, torch.bfloat16), ("bias", 256, 260, torch.bfloat16),
    ("bias", 96, 36, torch.bfloat16), ("bias", 6, 64, torch.float32),
    ("bias", 64, 66, torch.float32), ("res_ln", 48, 256, torch.bfloat16),
    ("res_ln", 64, 260, torch.bfloat16), ("res_ln", 64, 264, torch.bfloat16),
    ("res_ln", 64, 288, torch.float32), ("res_ln", 30, 64, torch.float32),
]


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("wrapper,k,n,dtype", REFUSED)
def test_gemm_wrappers_refuse_before_the_loader(no_loader, wrapper, k, n,
                                                dtype, drop):
    with pytest.raises(ValueError, match="GEMM kernels take"):
        _call(wrapper, 7, k, n, dtype, drop=drop, pre=drop)


def _geometry_shapes(hid, pf):
    """Every (wrapper, K, N) of a layer forward at these widths."""
    return ([("bias", hid, n) for n in (3 * hid, hid, 2 * hid, pf)]
            + [("res_ln", hid, hid), ("res_ln", pf, hid)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hid,pf", [(256, 512), (64, 128), (96, 160)])
def test_gemm_wrappers_take_every_layer_shape(no_loader, hid, pf, dtype):
    """Paper, default and hid 96 / pf 160 widths, forward (no site) and
    training (dropout sites, pre_out, out None): each call gets past the
    checks to the library (M = 1000: not a multiple of the 128-row
    tile)."""
    calls = 0
    for wrapper, k, n in _geometry_shapes(hid, pf):
        variants = ([dict(), dict(drop=True)] if wrapper == "bias" else
                    [dict(), dict(drop=True), dict(drop=True, pre=True),
                     dict(drop=True, pre=True, out=False)])
        for kw in variants:
            with pytest.raises(_Loader):
                _call(wrapper, 1000, k, n, dtype, **kw)
            calls += 1
    assert calls == 4 * 2 + 2 * 4


# ------------------------------------------------ the ctypes binding --

def _c_definitions():
    """``{name: parameter count}`` of every ``nylon_*`` function defined in
    ``csrc/*.cu``, macros that paste a suffix onto the name expanded."""
    src = "\n".join(p.read_text() for p in kernels.sources()
                    if p.suffix == ".cu")
    src = re.sub(r"\\\n", " ", src)
    expanded = []
    for mac, param, body in re.findall(
            r"#define\s+(\w+)\((\w+)[^)]*\)(.*)", src):
        for suffix in re.findall(rf"^\s*{mac}\(\s*(\w*)\s*,", src, re.M):
            expanded.append(body.replace(f"##{param}", suffix))
    defs = {}
    for name, params in re.findall(
            r"\b(?:int|const char\s*\*)\s+(nylon_\w+)\s*\(([^)]*)\)\s*\{",
            src + "\n".join(expanded)):
        assert name not in defs, f"{name} defined twice"
        defs[name] = len([p for p in params.split(",") if p.strip()])
    return defs


def test_every_bound_entry_point_is_defined_with_its_arity():
    defs = _c_definitions()
    assert "nylon_q8_gemm_bias_f32" in defs  # a macro-pasted name
    for name, argtypes in kernels._SIGNATURES.items():
        assert name in defs, f"{name}: no extern \"C\" definition"
        assert defs[name] == len(argtypes), (name, defs[name], len(argtypes))


def test_gemm_twins_use_the_kernel_masks():
    """The twins' masks are K6's (the hash of ``csrc/hash_mask.cuh``): the
    mask of a site equals ``hash_keep_mask_plain`` on the same rows."""
    for n in (96, 256):
        site = tlt._site(SEED, TAG, n, RATE, torch.bfloat16)
        y = torch.ones((M, n), dtype=torch.bfloat16)
        want = tatt.hash_keep_mask_plain(SEED, TAG, 0, (1, M, n), RATE,
                                         torch.bfloat16)[0]
        assert torch.equal(tlf._site_mask(site, y), want)
