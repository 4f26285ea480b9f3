"""The float32 forward GEMMs of the port (``csrc/layer_fused_f32.cu``'s
``gemm_bias_f32_kernel`` and ``gemm_res_ln_f32_kernel``: ``wgmma`` .tf32 as
3xTF32) on the CPU.

1. The weight pack, :func:`layer_fused.tf32_pair` (transpose + split), is
   bit for bit a numpy reference of ``csrc/tf32.cuh``'s ``split()``: ``big``
   by Veltkamp's split (``c = x * 8193``, ``big = c - (c - x)``), ``small =
   x - big`` with half a TF32 ulp added to its bits.
2. The kernels' arithmetic, emulated: A split as the consumers split it in
   registers, the pair as packed, every product of TF32 values (exact in
   f32) as the tensor core takes them, small*big + big*small + big*big a k8
   step in f32, k-blocks of 32 (ragged K zero-filled, as TMA fills it) in
   chains of ``CHAIN`` k-blocks, each chain's sum added into the f32
   accumulator, then the epilogues of ``layer_epilogue.cuh``. Held within ``chip_smoke.py`` (q)'s
   2e-5 of max(1, max |plain f32|) of the plain f32 twins
   (``gemm_bias_plain`` / ``gemm_res_ln_plain``) and of a float64 truth, at
   hid 64 / 96 / 256 (their pf 128 / 160 / 512), ragged M, with ReLU, the
   dropout site and ``pre_out``. One TF32 pass misses that limit, and a
   negative case asserts that it does. The twins themselves are held to the
   JAX package's f32 ``_matmul`` (within 2e-6, here and in
   ``tests/test_torch_gemm.py``).
3. The wrappers hand the float32 entry points the pair, refuse a pair of
   another shape and, on the card, a missing one, and the training step's weights carry the
   pairs the forward GEMMs read. The layer that the stem feeds, in
   inference and in training, takes its float32 QKV on the CUDA cores'
   GEMM, and no other layer does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu.ops import layer_fused as jlf
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt
from nylon_amt_tpu_torch.ops.precision import full_f32

from test_torch_attention_tf32 import rna_tf32

REL = 2e-5          # chip_smoke.py (q): of max(1, max |plain f32|)
CHAIN = 1           # k-blocks a wgmma chain (csrc/layer_fused_f32.cu's
                    # kChainF32; 0 would be one chain over all of K)
BK = 32             # the depth of a stage
SEED, RATE, TAG = 13_579, 0.1, 3
WIDTHS = [(64, 128), (96, 160), (256, 512)]  # (hid, pf)
M = 203             # not a multiple of the 128- or 64-row tiles


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (many small ops; the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the pack --

def split_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``csrc/tf32.cuh``'s ``split()`` in numpy: (big, small) as uint32
    bits."""
    x = x.astype(np.float32)
    c = (x * np.float32(8193.0)).astype(np.float32)
    big = (c - (c - x).astype(np.float32)).astype(np.float32)
    small = (x - big).astype(np.float32)
    return big.view(np.uint32), small.view(np.uint32) + np.uint32(0x1000)


def _weight(k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    # values on TF32 ties, signed zeros, a denormal, wide exponents
    w.flat[:8] = np.array([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11), 0.0,
                           -0.0, 1e-40, 3.0e30, -7.5e-30, 1.0 - 2.0 ** -24],
                          dtype=np.float32)
    return w


@pytest.mark.parametrize("k,n", [(64, 192), (96, 160), (36, 8)])
def test_pack_is_bit_identical_to_split(k, n):
    w = _weight(k, n, k + n)
    pair = tlf.tf32_pair(torch.from_numpy(w))
    big, small = split_np(w.T)
    assert pair.shape == (2, n, k) and pair.dtype == torch.float32
    assert pair.is_contiguous()
    assert np.array_equal(pair[0].numpy().view(np.uint32), big)
    assert np.array_equal(pair[1].numpy().view(np.uint32), small)
    # big + small is x to TF32 x TF32 precision (the dropped part < 2^-21)
    x = w.T.astype(np.float64)
    back = (big.view(np.float32).astype(np.float64)
            + _trunc13(pair[1]).numpy().astype(np.float64))
    assert np.all(np.abs(back - x) <= np.abs(x) * 2.0 ** -21 + 1e-44)


# ----------------------------------------------- the arithmetic, emulated --

def _trunc13(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: the low 13 bits
    dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def products(a, w, chain=CHAIN, passes=3):
    """``a [M, K] @ w [K, N]`` as the kernels take it: the pair packed
    from ``w``, A split as in registers (``passes`` 3: small*big +
    big*small + big*big a k8 step; 1: one TF32 pass), f32 sums a k8 step at
    a time, ``chain`` k-blocks of 32 a chain (0: one chain)."""
    pair = tlf.tf32_pair(w)
    wb, ws = pair[0].t(), _trunc13(pair[1]).t()
    a_pair = tlf.tf32_pair(a.t())        # the same split, of A
    ab, as_ = a_pair[0], _trunc13(a_pair[1])
    if passes == 1:
        ab, wb = rna_tf32(a), rna_tf32(w)
    k = a.shape[1]
    nk = -(-k // BK)
    acc = part = torch.zeros((a.shape[0], w.shape[1]))
    with full_f32():
        for kb in range(nk):
            for s in range(0, BK, 8):
                sl = slice(kb * BK + s, min(kb * BK + s + 8, k))
                if sl.start >= k:
                    continue        # zero-filled: adds nothing
                if passes == 3:
                    part = part + as_[:, sl] @ wb[sl]
                    part = part + ab[:, sl] @ ws[sl]
                part = part + ab[:, sl] @ wb[sl]
            if chain and (kb % chain == chain - 1 or kb == nk - 1):
                acc, part = acc + part, torch.zeros_like(part)
    return acc if chain else part


def _inputs(k, n, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))

    return dict(a=r(M, k), w=r(k, n, scale=k ** -0.5), bias=r(n, scale=0.1),
                res=r(M, n), g=1.0 + r(n, scale=0.1), b=r(n, scale=0.1))


def _site(n, drop):
    return tlt._site(SEED, TAG, n, RATE, torch.float32) if drop else None


def _mask(site, shape):
    return None if site is None else tlf._site_mask(site, torch.zeros(shape))


def emulate_bias(x, relu, site, **kw):
    y = products(x["a"], x["w"], **kw) + x["bias"]
    if relu:
        y = torch.relu(y)
    mask = _mask(site, y.shape)
    return y if mask is None else y * mask


def emulate_res_ln(x, site, **kw):
    y = products(x["a"], x["w"], **kw) + x["bias"]
    mask = _mask(site, y.shape)
    pre = x["res"] + (y if mask is None else y * mask)
    with full_f32():
        return tlf._layer_norm(pre, x["g"], x["b"]), pre


def truth_bias(x, relu, site):
    y = x["a"].double() @ x["w"].double() + x["bias"].double()
    if relu:
        y = torch.relu(y)
    mask = _mask(site, y.shape)
    return y if mask is None else y * mask.double()


def truth_res_ln(x, site):
    y = x["a"].double() @ x["w"].double() + x["bias"].double()
    mask = _mask(site, y.shape)
    pre = x["res"].double() + (y if mask is None else y * mask.double())
    m = pre.mean(-1, keepdim=True)
    var = (pre - m).square().mean(-1, keepdim=True)
    out = (pre - m) / torch.sqrt(var + 1e-5) * x["g"].double() \
        + x["b"].double()
    return out, pre


def rel(got, want) -> float:
    top = max(1.0, want.double().abs().max().item())
    return (got.double() - want.double()).abs().max().item() / top


def _bias_cases():
    return [(hid, k, n, relu, drop) for hid, pf in WIDTHS
            for k, n, relu, drop in ((hid, 3 * hid, False, False),
                                     (hid, pf, True, True))]


@pytest.mark.parametrize("hid,k,n,relu,drop", _bias_cases())
def test_3xtf32_gemm_bias_within_the_f32_gates(hid, k, n, relu, drop):
    x = _inputs(k, n, hid + k + n)
    site = _site(n, drop)
    got = emulate_bias(x, relu, site)
    with full_f32():
        want = tlf.gemm_bias_plain(x["a"], x["w"], x["bias"], relu, site)
    truth = truth_bias(x, relu, site)
    assert rel(got, want) <= REL
    assert rel(got, truth) <= REL
    assert rel(want, truth) <= REL


def _ln_cases():
    return [(hid, k, drop) for hid, pf in WIDTHS
            for k, drop in ((hid, False), (pf, True))]


@pytest.mark.parametrize("hid,k,drop", _ln_cases())
def test_3xtf32_gemm_res_ln_within_the_f32_gates(hid, k, drop):
    x = _inputs(k, hid, 7 * hid + k)
    site = _site(hid, drop)
    out, pre = emulate_res_ln(x, site)
    with full_f32():
        want_out, want_pre = tlf.gemm_res_ln_plain(
            x["a"], x["w"], x["bias"], x["res"], x["g"], x["b"], site)
    t_out, t_pre = truth_res_ln(x, site)
    for got, want, truth in ((out, want_out, t_out), (pre, want_pre, t_pre)):
        assert rel(got, want) <= REL
        assert rel(got, truth) <= REL


@pytest.mark.parametrize("kind", ["bias", "res_ln"])
def test_one_tf32_pass_misses_the_f32_gates(kind):
    hid, pf = WIDTHS[-1]
    if kind == "bias":
        x = _inputs(hid, pf, 1)
        got = emulate_bias(x, True, None, passes=1)
        with full_f32():
            want = tlf.gemm_bias_plain(x["a"], x["w"], x["bias"], True)
    else:
        x = _inputs(pf, hid, 2)
        got = emulate_res_ln(x, None, passes=1)[0]
        with full_f32():
            want = tlf.gemm_res_ln_plain(x["a"], x["w"], x["bias"],
                                         x["res"], x["g"], x["b"])[0]
    assert rel(got, want) > REL


def test_plain_f32_twin_is_jax_matmul():
    x = _inputs(96, 160, 3)
    with full_f32():
        got = tlf.gemm_bias_plain(x["a"], x["w"], x["bias"])
    want = np.asarray(jlf._matmul(jnp.asarray(x["a"].numpy()),
                                  jnp.asarray(x["w"].numpy()),
                                  jnp.asarray(x["bias"].numpy())))
    assert np.abs(got.numpy() - want).max() <= 2e-6


# ------------------------------------------------------- the wrappers --

@pytest.fixture
def calls(monkeypatch):
    """The (entry point, its arguments) of every kernel call."""
    seen = []
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    return seen


def test_f32_wrappers_hand_the_kernel_the_pair(calls):
    x = _inputs(96, 160, 4)
    pair = tlf.tf32_pair(x["w"])
    halves = (pair[0].data_ptr(), pair[1].data_ptr())
    tlf._gemm(x["a"], x["w"], x["bias"], pair=pair)
    tlt._gemm_bias(x["a"], x["w"], x["bias"], True, _site(160, True),
                   pair=pair)
    assert [(n, a[1:3]) for n, a in calls] == [
        ("nylon_gemm_bias_f32", halves), ("nylon_gemm_bias_drop_f32", halves)]
    # a pack_tf32 entry: two views of the layer's buffers
    z = torch.zeros
    p = tlf.EncoderLayerParams(z(96, 288), z(288), z(96, 96), z(96), z(96),
                               z(96), z(96, 160), z(160), x["w"].t(), z(96))
    big, small = tlf.pack_tf32(p)["w2"]
    res, g, b = torch.zeros((M, 96)), torch.ones(96), torch.zeros(96)
    a2 = torch.zeros((M, 160))
    tlf._gemm_res_ln(a2, p.w2, p.b2, res, g, b, pair=(big, small))
    assert calls[-1][0] == "nylon_gemm_res_ln_f32"
    assert calls[-1][1][1:3] == (big.data_ptr(), small.data_ptr())
    tlf._gemm_res_ln(a2, p.w2, p.b2, res, g, b)  # off the card: paired
    assert calls[-1][1][1] not in (big.data_ptr(), p.w2.data_ptr())
    # bf16 reads the weight itself
    a16, w16 = x["a"].bfloat16(), x["w"].bfloat16()
    tlf._gemm(a16, w16, x["bias"].bfloat16())
    assert calls[-1][0] == "nylon_gemm_bias"
    assert calls[-1][1][1] == w16.data_ptr()


def test_f32_wrappers_refuse_another_pair(calls):
    x = _inputs(96, 160, 5)
    for bad in (tlf.tf32_pair(x["w"]).transpose(1, 2),
                tlf.tf32_pair(x["w"][:, :128]), x["w"][None],
                tuple(tlf.tf32_pair(x["w"]).bfloat16())):
        with pytest.raises(ValueError, match="TF32 pair"):
            tlf._gemm(x["a"], x["w"], x["bias"], pair=bad)
    assert calls == []


def test_f32_gemm_on_the_card_refuses_a_missing_pair():
    """On the card a float32 GEMM takes its weight's pair or raises (the
    weight: its shape and device are all the check reads)."""
    from types import SimpleNamespace

    w = SimpleNamespace(shape=(96, 160), device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="none was given"):
        tlf.gemm_weight("gemm_bias", w, None, torch.float32)
    pair = tlf.tf32_pair(torch.zeros(96, 160))
    with pytest.raises(ValueError, match="TF32 pair"):   # on another device
        tlf.gemm_weight("gemm_bias", w, pair, torch.float32)


@pytest.fixture
def meta_route(monkeypatch, calls):
    """Meta tensors through the layer wrappers' kernel route: the device
    guard, the CUDA check and the SM count stubbed, the entry points
    recorded."""
    import contextlib

    def check_cuda(name, t, dtype, ndim=None):
        assert t.device.type == "meta" and t.dtype == dtype, (name, t)

    monkeypatch.setattr(kernels, "check_cuda", check_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tlt, "_sm_count", lambda index: 132)  # an H100's
    return calls


def _meta_enc(hid, pf, dt):
    def z(*s):
        return torch.empty(s, dtype=dt, device="meta")
    return tlf.EncoderLayerParams(
        z(hid, 3 * hid), z(3 * hid), z(hid, hid), z(hid),
        torch.empty(hid, device="meta"), torch.empty(hid, device="meta"),
        z(hid, pf), z(pf), z(pf, hid), z(hid))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_stem_fed_layers_take_the_ffma_qkv(meta_route, dt):
    hid, pf, heads, n = 64, 128, 2, 2
    p = _meta_enc(hid, pf, dt)
    x = torch.empty((n, 256, hid), dtype=dt, device="meta")
    f32 = dt == torch.float32
    tf32 = tlf.pack_tf32(p) if f32 else None
    stem_in = (torch.empty((n, 192, 256), device="meta"),
               torch.empty((65, hid), device="meta"),
               torch.empty((hid,), device="meta"),
               torch.empty((256, hid), dtype=dt, device="meta"))
    gemms = ("nylon_gemm_bias", "nylon_gemm_bias_f32",
             "nylon_gemm_bias_drop", "nylon_gemm_bias_drop_f32",
             "nylon_gemm_bias_ffma_f32")

    def qkv(run):
        """The entry point of the first GEMM that ``run`` launches."""
        meta_route.clear()
        run()
        return next(name for name, _ in meta_route if name in gemms)

    ffma = "nylon_gemm_bias_ffma_f32"
    plain = "nylon_gemm_bias_f32" if f32 else "nylon_gemm_bias"
    kernels.reset_launches()
    assert qkv(lambda: tlf.encoder_layer_with_stem(
        *stem_in, p, heads, 128, dt, tf32=tf32)) == (ffma if f32 else plain)
    assert qkv(lambda: tlf.encoder_layer(x, p, heads, tf32=tf32)) == plain
    p32 = _meta_enc(hid, pf, torch.float32)  # training's master weights
    for stem in (True, False):
        want = ffma if stem and f32 else plain
        assert qkv(lambda: tlt.encoder_layer_train_cuda(
            x, p32, 3, heads, 0.0, True, stem=stem)) == want
        assert qkv(lambda: tlt.encoder_layer_train_bwd_cuda(
            x, p32, 3, x, heads, 0.0, True, stem=stem)) == want
    assert kernels.launches["gemm_bias_ffma_f32"] == (3 if f32 else 0)


def test_pack_tf32_covers_every_weight_matrix():
    rng = np.random.default_rng(6)
    p = tlf.EncoderLayerParams(*(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for s in (
            (64, 192), (192,), (64, 64), (64,), (64,), (64,), (64, 128),
            (128,), (128, 64), (64,))))
    pairs = tlf.pack_tf32(p)
    assert sorted(pairs) == ["w1", "w2", "wo", "wqkv"]
    for f, (big, small) in pairs.items():   # tf32_pair's bits
        want = tlf.tf32_pair(getattr(p, f))
        assert big.is_contiguous() and small.is_contiguous()
        assert torch.equal(big.view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(small.view(torch.int32),
                           want[1].view(torch.int32))
    # the training step's weights: the pairs for f32, none for bf16
    w = tlt.compute_weights(p, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(w.pair("w1"), pairs["w1"]))
    assert tlt.compute_weights(p, torch.bfloat16).pair("w1") is None
