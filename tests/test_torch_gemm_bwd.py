"""The bf16 backward GEMMs of the port (``csrc/layer_fused_train.cu``'s
``gemm_nt_kernel``, dX = dY W^T with its epilogue, and ``wgrad_kernel``,
dW = A^T dY with the bias sums) on the CPU: their plain twins, the
composition of the plain training backward from them, and what their
wrappers check and plan before the kernel library loads.

1. ``gemm_nt_plain`` with every combination of its epilogue (ReLU gate,
   addend, keep masks m1 and m2) and ``weight_grad_plain`` against the JAX
   package's own operations on seeded numpy inputs: ``jax.lax.dot_general``
   with f32 accumulation, then ``.astype``, the masks of
   ``nylon_amt_tpu.ops.attention.hash_keep_mask``. f32 within 2e-6; bf16
   by ``tests/test_torch_gemm.py``'s gate (the port's error from the f32
   truth within twice JAX's + 1e-3), JAX run in a fresh interpreter
   without XLA's excess precision so that it rounds where its code casts.
2. The plain K7/K8/K9 backward is, stage for stage, the composition of the
   two twins as the CUDA backward wires the kernels (the gate is the
   forward's masked ReLU output, the masks are the kernels' dropout
   sites), bit for bit, in f32 and bf16.
3. The wrappers refuse with ``ValueError``, before the library is loaded,
   what the C entry points refuse (bf16: N, Kout, Ka % 8, one side input
   and one dropout site at a time; f32: % 4), and take every product of
   the paper, default and hid-96 / pf-160 widths.
4. ``wgrad_plan``: chunks of a multiple of 64 rows, each row in exactly
   one chunk, no chunk empty, at most 65,535 chunks and one wave of blocks.
"""

import functools
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nylon_amt_tpu.ops import attention as jatt
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

HERE = Path(__file__).resolve().parent
M, N_IN, SEED, RATE = 40, 64, 24_680, 0.1
TAGS = {"m1": tlt._SITE_FFN_MID, "m2": tlt._SITE_EMB}


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


def _nt_inputs(kout, seed):
    """dy [M, N_IN], w [kout, N_IN], gate and addend [M, kout] (bf16
    values)."""
    rng = np.random.default_rng(seed)
    return dict(dy=_bf16_values(rng.standard_normal((M, N_IN))),
                w=_bf16_values(rng.standard_normal((kout, N_IN))
                               / np.sqrt(N_IN)),
                gate=_bf16_values(rng.standard_normal((M, kout))),
                addend=_bf16_values(rng.standard_normal((M, kout))))


# (Kout, gate, addend, m1, m2): every epilogue combination at Kout 96
# (unpacked masks), and the masked ones at Kout 256 (packed 16-bit draws)
NT_CASES = ([(96, *c) for c in itertools.product((0, 1), repeat=4)]
            + [(256, g, a, 1, 1) for g, a in ((0, 0), (1, 0), (0, 1),
                                              (1, 1))])
# (Ka, N) of the dW twin
WG_CASES = [(96, 256), (256, 64)]
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_nt(x, case, dtype_name):
    """The JAX kernels' dX step (``_enc_train_bwd_kernel``): dot_general of
    dy and W over W's second axis, f32 accumulation, cast; the masks, the
    ReLU gate compared in f32, the addend. f32 numpy."""
    kout, gate, addend, m1, m2 = case
    dt = _DT[dtype_name][0]
    v = jax.lax.dot_general(
        jnp.asarray(x["dy"]).astype(dt)[None], jnp.asarray(x["w"]).astype(dt),
        (((2,), (1,)), ((), ())), preferred_element_type=jnp.float32
    ).astype(dt)

    def mask(name):
        return jatt.hash_keep_mask(jnp.int32(SEED), TAGS[name], 0,
                                   (1, M, kout), RATE, dt)

    if m1:
        v = v * mask("m1")
    if gate:
        v = jnp.where(jnp.asarray(x["gate"])[None] > 0, v, 0).astype(dt)
    if addend:
        v = jnp.asarray(x["addend"]).astype(dt)[None] + v
    if m2:
        v = v * mask("m2")
    return np.asarray(v[0].astype(jnp.float32))


def _port_nt(x, case, dtype_name):
    kout, gate, addend, m1, m2 = case
    dt = _DT[dtype_name][1]
    t = {k: torch.from_numpy(v).to(dt) for k, v in x.items()}
    sites = {name: tlt._site(SEED, TAGS[name], kout, RATE, dt)
             for name, on in (("m1", m1), ("m2", m2)) if on}
    v = tlt.gemm_nt_plain(t["dy"], t["w"], gate=t["gate"] if gate else None,
                          addend=t["addend"] if addend else None, **sites)
    assert v.dtype == dt and tuple(v.shape) == (M, kout)
    return v.float().numpy()


def _wg_inputs(ka, n, seed):
    rng = np.random.default_rng(seed)
    return dict(a=_bf16_values(rng.standard_normal((M, ka))),
                dy=_bf16_values(rng.standard_normal((M, n))))


def _jax_wg(x, dtype_name):
    """The JAX kernels' dW step: dot_general of the flat rows, f32, and the
    f32 column sums."""
    dt = _DT[dtype_name][0]
    a, dy = (jnp.asarray(x[k]).astype(dt)[None] for k in ("a", "dy"))
    flat = lambda t: t.reshape(-1, t.shape[-1])
    dw = jax.lax.dot_general(flat(a), flat(dy), (((0,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    return [np.asarray(dw), np.asarray(jnp.sum(dy.astype(jnp.float32),
                                               axis=(0, 1)))]


def _port_wg(x, dtype_name):
    dt = _DT[dtype_name][1]
    dw, db = tlt.weight_grad_plain(torch.from_numpy(x["a"]).to(dt),
                                   torch.from_numpy(x["dy"]).to(dt))
    assert dw.dtype == db.dtype == torch.float32
    return [dw.numpy(), db.numpy()]


def _seed(case):
    return sum(int(c) << i for i, c in enumerate(case[1:])) + case[0]


@pytest.mark.parametrize("case", NT_CASES)
def test_gemm_nt_twin_matches_jax_f32(case):
    x = _nt_inputs(case[0], _seed(case))
    got, want = _port_nt(x, case, "f32"), _jax_nt(x, case, "f32")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("ka,n", WG_CASES)
def test_weight_grad_twin_matches_jax_f32(ka, n):
    x = _wg_inputs(ka, n, ka + n)
    for got, want in zip(_port_wg(x, "f32"), _jax_wg(x, "f32")):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


def _bf16_gate_errors():
    """``{case: (port error, JAX error)}`` from the f32 truth, at bf16, for
    every twin case; errors relative to max(|truth|, 1)."""
    rows = {}

    def err(got, ref):
        return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1)))

    for case in NT_CASES:
        x = _nt_inputs(case[0], _seed(case))
        truth = _jax_nt(x, case, "f32")
        rows[f"nt{case}"] = (err(_port_nt(x, case, "bf16"), truth),
                             err(_jax_nt(x, case, "bf16"), truth))
    for ka, n in WG_CASES:
        x = _wg_inputs(ka, n, ka + n)
        truth = _jax_wg(x, "f32")
        for i, (p16, j16) in enumerate(zip(_port_wg(x, "bf16"),
                                           _jax_wg(x, "bf16"))):
            rows[f"wg{(ka, n)}-{i}"] = (err(p16, truth[i]),
                                        err(j16, truth[i]))
    return rows


@functools.lru_cache(maxsize=1)
def _bf16_gate_rows():
    """``_bf16_gate_errors`` from a fresh interpreter with XLA's excess
    precision off, where JAX rounds where its code casts."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(HERE)!r})\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_gemm_bwd as t\n"
            "print(json.dumps(t._bf16_gate_errors()))\n")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [f"nt{c}" for c in NT_CASES]
                         + [f"wg{c}-{i}" for c in WG_CASES for i in (0, 1)])
def test_bwd_gemm_twin_bf16_gate(name):
    e_port, e_jax = _bf16_gate_rows()[name]
    assert e_port <= 2.0 * e_jax + 1e-3, (name, e_port, e_jax)


def test_gemm_nt_twin_epilogue_steps_matter():
    """Each epilogue argument changes the result (the cases above would
    not see a twin that ignored one)."""
    x = _nt_inputs(96, 7)
    base = _port_nt(x, (96, 0, 0, 0, 0), "f32")
    for i in range(1, 5):
        case = tuple(1 if j == i else 0 for j in range(5))
        assert not np.allclose(_port_nt(x, (96, *case[1:]), "f32"), base)


# ------------------------------ the plain backward from the twins --

HID, PF, HEADS, NQ, NK = 32, 96, 2, 20, 48


def _params(cls, seed):
    rng = np.random.default_rng(seed)
    shapes = tlf.weight_shapes(HID, PF)
    out = {}
    for f in cls._fields:
        shape = shapes[f]
        if f == "g":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif f.startswith("w"):
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[f] = torch.from_numpy(_bf16_values(a))
    return cls(**out)


def _acts(dtype, seed, *lengths):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(_bf16_values(rng.standard_normal(
        (2, n, HID)))).to(dtype) for n in lengths]


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what


def _check_ffn_tail(t, p, dt, pre=""):
    """The dX and dW stages of the FFN + output-projection backward in taps
    ``t`` (names with prefix ``pre``), from the twins as the kernels run
    them: du gated by the masked ReLU output with the FFN site's mask."""
    c = lambda f: getattr(p, f).to(dt)
    v = lambda name: t[pre + name]
    wg = tlt.weight_grad_plain
    for dw, db, a, dy in (("dw2", "db2", "midd", "dff"),
                          ("dw1", "db1", "y", "du"),
                          ("dwo", "dbo", "heads", "dattn")):
        got = wg(v(a), v(dy))
        _same(got[0], v(dw), pre + dw)
        _same(got[1], v(db), pre + db)
    site = tlt._site(SEED, tlt._SITE_FFN_MID, PF, RATE, dt)
    _same(tlt.gemm_nt_plain(v("dff"), c("w2"), gate=v("midd"), m1=site),
          v("du"), pre + "du")
    _same(tlt.gemm_nt_plain(v("du"), c("w1"), addend=v("da2")), v("dy"),
          pre + "dy")
    _same(tlt.gemm_nt_plain(v("dattn"), c("wo")), v("dheads"),
          pre + "dheads")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["enc", "dec_zero", "dec"])
def test_plain_backward_is_its_twins_composition(kind, dtype):
    taps = {}
    if kind == "enc":
        p = _params(tlf.EncoderLayerParams, 1)
        x, dz = _acts(dtype, 2, NK, NK)
        tlt.encoder_layer_train_bwd_plain(x, p, SEED, dz, HEADS, RATE,
                                          emb_drop=True, taps=taps)
        _check_ffn_tail(taps, p, dtype)
        got = tlt.weight_grad_plain(taps["x"], taps["dqkv"])
        _same(got[0], taps["dwqkv"], "dwqkv")
        _same(got[1], taps["dbqkv"], "dbqkv")
        m0 = tlt._site(SEED, tlt._SITE_EMB, HID, RATE, dtype)
        _same(tlt.gemm_nt_plain(taps["dqkv"], p.wqkv.to(dtype),
                                addend=taps["da1"], m2=m0), taps["dx"], "dx")
        return
    cls = tlt.DecZeroParams if kind == "dec_zero" else tlt.DecLayerParams
    p = _params(cls, 3)
    trg, enc, dz = _acts(dtype, 4, NQ, NK, NQ)
    bwd = (tlt.decoder_layer_zero_train_bwd_plain if kind == "dec_zero"
           else tlt.decoder_layer_train_bwd_plain)
    bwd(trg, enc, p, SEED, dz, HEADS, RATE, taps=taps)
    _check_ffn_tail(taps, p, dtype, "cross.")
    wg = tlt.weight_grad_plain
    for dw, db, a, dy in (("dwq", "dbq", "trg", "dq"),
                          ("dwkv", "dbkv", "enc", "dkv")):
        got = wg(taps["cross." + a], taps["cross." + dy])
        _same(got[0], taps["cross." + dw], dw)
        _same(got[1], taps["cross." + db], db)
    _same(tlt.gemm_nt_plain(taps["cross.dq"], p.wq.to(dtype),
                            addend=taps["cross.da1"]), taps["cross.dtrg"],
          "cross.dtrg")
    _same(tlt.gemm_nt_plain(taps["cross.dkv"], p.wkv.to(dtype)),
          taps["cross.denc"], "cross.denc")
    if kind == "dec":
        for dw, db, a, dy in (("dwso", "dbso", "sheads", "dsa"),
                              ("dwsqkv", "dbsqkv", "trg", "dqkv")):
            got = wg(taps["self." + a], taps["self." + dy])
            _same(got[0], taps["self." + dw], dw)
            _same(got[1], taps["self." + db], db)
        _same(tlt.gemm_nt_plain(taps["self.dsa"], p.wso.to(dtype)),
              taps["self.dsheads"], "self.dsheads")
        _same(tlt.gemm_nt_plain(taps["self.dqkv"], p.wsqkv.to(dtype),
                                addend=taps["self.da0"]), taps["self.dtrg"],
              "self.dtrg")


# ------------------------------------------------ the wrappers' checks --

class _Loader(Exception):
    """Raised where the kernel library would load."""


@pytest.fixture
def no_loader(monkeypatch):
    def load():
        raise _Loader

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(tlt, "_sm_count", lambda index: 132)


def _nt_call(m, n, kout, dtype, gate=False, addend=False, m1=False,
             m2=False, side_rows=None):
    rows = m if side_rows is None else side_rows
    side = lambda on: torch.zeros((rows, kout), dtype=dtype) if on else None
    site = lambda on, tag: tlt._site(SEED, tag, kout, RATE, dtype) if on \
        else None
    return tlt._gemm_nt(torch.zeros((m, n), dtype=dtype),
                        torch.zeros((kout, n), dtype=dtype), gate=side(gate),
                        addend=side(addend), m1=site(m1, tlt._SITE_FFN_MID),
                        m2=site(m2, tlt._SITE_EMB))


def _wg_call(m, ka, n, dtype):
    return tlt._weight_grad(torch.zeros((m, ka), dtype=dtype),
                            torch.zeros((m, n), dtype=dtype))


NT_REFUSED = [  # (N, Kout, dtype, side inputs): what nylon_gemm_nt refuses
    (36, 64, torch.bfloat16, {}), (64, 100, torch.bfloat16, {}),
    (256, 512, torch.bfloat16, dict(gate=True, addend=True)),
    (6, 64, torch.float32, {}), (64, 66, torch.float32, {}),
    (64, 64, torch.bfloat16, dict(gate=True, side_rows=7)),
    (256, 256, torch.bfloat16, dict(m1=True, m2=True)),
]
WG_REFUSED = [  # (Ka, N, dtype): what nylon_wgrad refuses
    (36, 64, torch.bfloat16), (64, 100, torch.bfloat16),
    (6, 64, torch.float32), (64, 66, torch.float32),
]


@pytest.mark.parametrize("n,kout,dtype,kw", NT_REFUSED)
def test_gemm_nt_wrapper_refuses_before_the_loader(no_loader, n, kout, dtype,
                                                   kw):
    with pytest.raises(ValueError, match="dX kernel|has shape"):
        _nt_call(9, n, kout, dtype, **kw)


@pytest.mark.parametrize("ka,n,dtype", WG_REFUSED)
def test_wgrad_wrapper_refuses_before_the_loader(no_loader, ka, n, dtype):
    with pytest.raises(ValueError, match="dW kernel"):
        _wg_call(9, ka, n, dtype)


def _bwd_products(hid, pf):
    """Every dX (N, Kout, side input, m1, m2) and dW (Ka, N) of a training
    step's backward at these widths."""
    dx = [(hid, pf, "gate", True, False), (pf, hid, "addend", False, False),
          (hid, hid, None, False, False), (hid, hid, "addend", False, False),
          (3 * hid, hid, "addend", False, False),
          (3 * hid, hid, "addend", False, True),
          (2 * hid, hid, None, False, False)]
    dw = [(pf, hid), (hid, pf), (hid, hid), (hid, 3 * hid), (hid, 2 * hid)]
    return dx, dw


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hid,pf", [(256, 512), (64, 128), (96, 160)])
def test_bwd_wrappers_take_every_step_product(no_loader, hid, pf, dtype):
    """Paper, default and hid 96 / pf 160 widths: each call gets past the
    checks to the library (M = 1000: not a multiple of the 128-row tile
    or of the 64-row chunk)."""
    dx, dw = _bwd_products(hid, pf)
    for n, kout, side, m1, m2 in dx:
        with pytest.raises(_Loader):
            _nt_call(1000, n, kout, dtype, m1=m1, m2=m2,
                     **({side: True} if side else {}))
    for ka, n in dw:
        with pytest.raises(_Loader):
            _wg_call(1000, ka, n, dtype)


# ---------------------------------------------------- the chunk plan --

@pytest.mark.parametrize("m", [1, 63, 64, 65, 1000, 35_201, 90_112,
                               100_003, 262_144, 10_000_000])
def test_wgrad_plan_covers_every_row_once(m):
    for tiles in (1, 2, 4, 6, 131, 132, 200):
        rows, chunks = tlt.wgrad_plan(m, tiles, 132)
        assert rows > 0 and rows % 64 == 0, (m, tiles, rows)
        assert 1 <= chunks <= 65535
        # chunk c holds rows [c * rows, min(m, (c + 1) * rows)): every row
        # in one chunk, the last chunk not empty
        assert (chunks - 1) * rows < m <= chunks * rows, (m, tiles, rows)
        assert tiles * chunks <= max(132, tiles)  # one wave
        if m >= 64 * 132 and tiles <= 66:  # the card filled
            assert tiles * chunks > 132 // 2, (m, tiles, chunks)
