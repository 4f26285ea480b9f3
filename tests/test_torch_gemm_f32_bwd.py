"""The float32 backward GEMMs of the port (``csrc/layer_fused_f32.cu``'s
``gemm_nt_f32_kernel``, dX = dY W^T with its epilogue, and
``wgrad_f32_kernel``, dW = A^T dY with the bias sums: ``wgmma`` .tf32 as
3xTF32) on the CPU.

1. The kernels' arithmetic, emulated (``test_torch_gemm_f32.products``: the
   operand split of ``csrc/tf32.cuh``, small*big + big*small + big*big a k8
   step in f32, k-blocks of 32 in chains of one k-block, each chain added
   into the f32 sum): dX with dY as A and the weight's dX pair as B, then
   ``nt_epilogue``; dW over each row chunk of the kernel's plan with A^T as
   A and dY's split as B, the partials and the bias sums (each part of the
   rows in row order) added in chunk order. Held to ``chip_smoke.py`` (r)'s
   limits on seeded numpy inputs at hid 64 / 96 / 256: dX within 2e-5 of
   max(1, max |plain f32 twin|) and of a float64 truth; dW and the bias sums
   no further from the float64 truth than twice the plain f32 twin's own
   distance + 1e-6 max |truth|; the products also against the JAX
   package's f32 ``dot_general`` of the backward bodies.
2. ``pack_tf32(..., nt=True)``: the forward's pairs and dX's pairs of every
   matrix of ``EncoderLayerParams`` and ``CrossLayerParams``, bit for bit
   ``csrc/tf32.cuh``'s split of ``w^T`` and of ``w``, from one split; the
   training step's ``Weights`` hands them out.
3. The float32 dW chunk plan (``wgrad_plan`` over ``wgrad_tile``'s tiles,
   rows a multiple of 32) covers every row exactly once.
4. The wrappers hand the f32 dX kernel the dX pair (every dX call of the
   training backward its weight's), and refuse before the library loads
   what the kernels do not take.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt
from nylon_amt_tpu_torch.ops.precision import full_f32

from test_torch_gemm_f32 import products, split_np

REL = 2e-5          # chip_smoke.py (r): dX of max(1, max |plain f32|)
BK = 32             # rows a k-block of the dW kernel
SMS = 132           # an H100's SMs, for the chunk plan
SEED, RATE = 97_531, 0.1
WIDTHS = [(64, 128), (96, 160), (256, 512)]  # (hid, pf)
M = 203             # not a multiple of the 128-row tile or a 32-row chunk


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (many small ops; the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape))
                            .astype(np.float32))


def _rel(got, want) -> float:
    top = max(1.0, want.double().abs().max().item())
    return (got.double() - want.double()).abs().max().item() / top


def _dist(got, truth) -> float:
    return (got.double() - truth).abs().max().item()


# ------------------------------------------------------------------ dX --

def _nt_cases():
    """(hid, N, Kout, side input, m1, m2): the dX products of a training
    layer's backward (FFN down with its gate and site, FFN up with the
    addend, O, QKV with the addend and the embedding site)."""
    return [(hid, n, kout, side, m1, m2) for hid, pf in WIDTHS
            for n, kout, side, m1, m2 in ((hid, pf, "gate", True, False),
                                          (pf, hid, "addend", False, False),
                                          (hid, hid, None, False, False),
                                          (3 * hid, hid, "addend", False,
                                           True))]


def _wg_cases():
    """(hid, Ka, N): the dW products (FFN down and up, QKV)."""
    return [(hid, ka, n) for hid, pf in WIDTHS
            for ka, n in ((pf, hid), (hid, pf), (hid, 3 * hid))]


def _jax_dot(x, w, dims):
    return torch.from_numpy(np.array(jax.lax.dot_general(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), (dims, ((), ())),
        preferred_element_type=jnp.float32)))


@pytest.mark.parametrize("hid,n,kout,side,m1,m2", _nt_cases())
def test_3xtf32_gemm_nt_within_the_f32_gates(hid, n, kout, side, m1, m2):
    rng = np.random.default_rng(hid + 3 * n + kout)
    dy, w = _r(rng, M, n), _r(rng, kout, n, scale=n ** -0.5)
    sides = {side: _r(rng, M, kout)} if side else {}
    site1 = tlt._site(SEED, tlt._SITE_FFN_MID, kout, RATE,
                      torch.float32) if m1 else None
    site2 = tlt._site(SEED, tlt._SITE_EMB, kout, RATE,
                      torch.float32) if m2 else None
    # the kernel's B is w's dX pair: the split products() packs for w^T
    pair = tlf.tf32_pair(w, nt=True)
    assert torch.equal(pair, tlf.tf32_pair(w.t()))
    prod = products(dy, w.t())
    # nt_epilogue on the emulated products (the plain twin's op sequence)
    with full_f32():
        got = prod
        if site1 is not None:
            got = got * tlf._site_mask(site1, got)
        if side == "gate":
            got = torch.where(sides["gate"] > 0, got, torch.zeros_like(got))
        if side == "addend":
            got = sides["addend"] + got
        if site2 is not None:
            got = got * tlf._site_mask(site2, got)
        want = tlt.gemm_nt_plain(dy, w, m1=site1, m2=site2, **sides)
        truth = tlt.gemm_nt_plain(
            dy.double(), w.double(), m1=site1, m2=site2,
            **{k: v.double() for k, v in sides.items()})
    assert _rel(got, want) <= REL
    assert _rel(got, truth) <= REL
    # the product against the JAX kernels' dot_general of dy and W over W's
    # second axis (_enc_train_bwd_kernel's dX step)
    assert _rel(prod, _jax_dot(dy, w, ((1,), (1,)))) <= REL


# ------------------------------------------------------------------ dW --

def emulate_wgrad(a, dy):
    """``(a^T dy, column sums of dy)`` as ``wgrad_f32_kernel`` and
    ``reduce_rows`` take them: the kernel's row chunks (``wgrad_plan`` over
    ``wgrad_tile``'s tiles), each chunk's partial by ``products`` (A^T split
    as the register operand, dy's split as the re-staged pair, k-blocks of
    32 rows, one chain a k-block), each bias part (the block of Ka tile kt:
    stage rows kt + n_kt p, + n_kt kParts, ... of every stage, in order)
    summed in f32, then the partials added in chunk order."""
    m, ka = a.shape
    n = dy.shape[1]
    bm, bn = tlt.wgrad_tile(ka, n, torch.float32)
    n_kt, parts = -(-ka // bm), 256 // (bn // 2)
    rows, chunks = tlt.wgrad_plan(m, n_kt * -(-n // bn), SMS, BK)
    dw, db = torch.zeros((ka, n)), torch.zeros(n)
    with full_f32():
        for c in range(chunks):
            blk = slice(c * rows, min(m, (c + 1) * rows))
            dw = dw + products(a[blk].t().contiguous(), dy[blk])
            pad = torch.zeros((-(-(blk.stop - blk.start) // BK) * BK, n))
            pad[:blk.stop - blk.start] = dy[blk]
            stages = pad.view(-1, BK, n)
            for kt in range(n_kt):
                sums = torch.zeros((parts, n))
                for p in range(parts):
                    for st in stages:
                        for rr in range(kt + n_kt * p, BK, n_kt * parts):
                            sums[p] = sums[p] + st[rr]
                total = sums[0]
                for p in range(1, parts):
                    total = total + sums[p]
                db = db + total
    return dw, db


@pytest.mark.parametrize("hid,ka,n", _wg_cases())
def test_3xtf32_wgrad_within_the_f32_gates(hid, ka, n):
    rng = np.random.default_rng(7 * hid + ka + n)
    a, dy = _r(rng, M, ka), _r(rng, M, n)
    got = emulate_wgrad(a, dy)
    with full_f32():
        want = tlt.weight_grad_plain(a, dy)
    truth = (a.double().t() @ dy.double(), dy.double().sum(0))
    for g, p, t in zip(got, want, truth):
        assert _dist(g, t) <= 2 * _dist(p, t) + 1e-6 * t.abs().max().item()
    # the product against the JAX kernels' dot_general over the rows (the
    # dW step of the backward bodies)
    jax_dw = _jax_dot(a, dy, ((0,), (0,)))
    t = truth[0]
    assert _dist(got[0], t) <= 2 * _dist(jax_dw, t) \
        + 1e-6 * t.abs().max().item()


# ------------------------------------------------------------ the pack --

def _params(cls, hid, pf, seed):
    rng = np.random.default_rng(seed)
    shapes = tlf.weight_shapes(hid, pf)
    vals = []
    for f in cls._fields:
        x = rng.standard_normal(shapes[f]).astype(np.float32)
        if x.ndim == 2:   # TF32 ties, signed zeros, a denormal, wide range
            x.flat[:8] = np.array([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11),
                                   0.0, -0.0, 1e-40, 3.0e30, -7.5e-30,
                                   1.0 - 2.0 ** -24], dtype=np.float32)
        vals.append(torch.from_numpy(x))
    return cls(*vals)


@pytest.mark.parametrize("cls", [tlf.EncoderLayerParams,
                                 tlf.CrossLayerParams])
def test_pack_gives_both_pairs_bit_identical_to_split(cls):
    p = _params(cls, 96, 160, len(cls._fields))
    mats = [f for f, t in zip(p._fields, p) if t.dim() == 2]
    pairs = tlf.pack_tf32(p, nt=True)
    assert sorted(pairs) == sorted(mats + [f + "_nt" for f in mats])
    fwd = tlf.pack_tf32(p)
    for f in mats:
        w = getattr(p, f).numpy()
        for key, x in ((f, w.T), (f + "_nt", w)):
            big, small = pairs[key]
            want_big, want_small = split_np(x)
            assert big.is_contiguous() and small.is_contiguous()
            assert tuple(big.shape) == x.shape == tuple(small.shape)
            assert np.array_equal(big.numpy().view(np.uint32), want_big)
            assert np.array_equal(small.numpy().view(np.uint32), want_small)
        # the forward's pairs are pack_tf32(p)'s, and dX's their transpose
        for h in range(2):
            assert torch.equal(pairs[f][h], fwd[f][h])
            assert torch.equal(pairs[f + "_nt"][h], fwd[f][h].t())
    # one split over one buffer: every pair views the same two buffers
    bases = {(b.untyped_storage().data_ptr(), s.untyped_storage().data_ptr())
             for b, s in pairs.values()}
    assert len(bases) == 1
    # the training step's weights carry both
    wts = tlt.compute_weights(p, torch.float32)
    for f in mats:
        assert all(torch.equal(x, y) for x, y in
                   zip(wts.pair(f, nt=True), pairs[f + "_nt"]))
        assert all(torch.equal(x, y) for x, y in
                   zip(wts.pair(f), pairs[f]))
    assert tlt.compute_weights(p, torch.bfloat16).pair(mats[0], nt=True) \
        is None


# ------------------------------------------------------- the chunk plan --

@pytest.mark.parametrize("m", [1, 31, 32, 33, 1000, 35_201, 90_112,
                               100_003, 262_144, 10_000_000])
def test_wgrad_f32_plan_covers_every_row_once(m):
    for ka, n in ((64, 64), (64, 192), (128, 64), (96, 160), (256, 768),
                  (512, 256), (8, 8)):
        bm, bn = tlt.wgrad_tile(ka, n, torch.float32)
        assert bm in (64, 128) and bn in (64, 128)
        tiles = -(-ka // bm) * -(-n // bn)
        rows, chunks = tlt.wgrad_plan(m, tiles, SMS, BK)
        assert rows > 0 and rows % BK == 0, (m, ka, n, rows)
        assert 1 <= chunks <= 65535
        # chunk c holds rows [c * rows, min(m, (c + 1) * rows)): every row
        # in one chunk, the last chunk not empty
        assert (chunks - 1) * rows < m <= chunks * rows, (m, ka, n, rows)
        assert tiles * chunks <= max(SMS, tiles)  # one wave
        if m >= BK * SMS and tiles <= SMS // 2:   # the card filled
            assert tiles * chunks > SMS // 2, (m, ka, n, chunks)


# ------------------------------------------------------- the wrappers --

@pytest.fixture
def calls(monkeypatch):
    """The (entry point, its arguments) of every kernel call."""
    seen = []
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(tlt, "_sm_count", lambda index: SMS)
    return seen


class _Loader(Exception):
    """Raised where the kernel library would load."""


def test_f32_dx_wrapper_hands_the_kernel_the_pair(calls):
    rng = np.random.default_rng(1)
    dy, w = _r(rng, M, 96), _r(rng, 160, 96)
    gate = _r(rng, M, 160)
    pair = tlf.tf32_pair(w, nt=True)
    kernels.reset_launches()
    tlt._gemm_nt(dy, w, gate=gate, pair=pair)
    name, args = calls[-1]
    assert name == "nylon_gemm_nt_f32"
    assert args[1:3] == (pair[0].data_ptr(), pair[1].data_ptr())
    tlt._gemm_nt(dy, w)                    # off the card: paired here
    assert calls[-1][0] == "nylon_gemm_nt_f32"
    assert calls[-1][1][1] not in (pair[0].data_ptr(), w.data_ptr())
    assert kernels.launches["gemm_nt_f32"] == 2
    # the forward's [N, K] pair is not dX's
    for bad in (tlf.tf32_pair(w), pair.transpose(1, 2),
                tuple(pair.bfloat16())):
        with pytest.raises(ValueError, match="TF32 pair"):
            tlt._gemm_nt(dy, w, pair=bad)
    # bf16 reads the weight itself
    tlt._gemm_nt(dy.bfloat16(), w.bfloat16())
    assert calls[-1][0] == "nylon_gemm_nt"


def test_f32_dw_wrapper_takes_the_f32_plan(calls):
    kernels.reset_launches()
    for ka, n in ((64, 192), (256, 768), (96, 160)):
        m = 5_001
        tlt._weight_grad(torch.zeros((m, ka)), torch.zeros((m, n)))
        name, args = calls[0]
        calls.clear()   # the wgrad call, then the two reductions
        assert name == "nylon_wgrad_f32"
        rows, chunks = args[7], args[8]
        bm, bn = tlt.wgrad_tile(ka, n, torch.float32)
        assert (rows, chunks) == tlt.wgrad_plan(
            m, -(-ka // bm) * -(-n // bn), SMS, BK)
        # the kernel takes its tile from the wrapper, which sized the
        # bias sums by it
        assert args[9:11] == (bm, bn)
        assert tlt.wgrad_layout(m, ka, n, torch.float32, SMS) == (
            bm, bn, rows, chunks)
    assert kernels.launches["wgrad_f32"] == 3


def _refused(monkeypatch):
    def load():
        raise _Loader

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)


@pytest.mark.parametrize("n,kout,kw", [
    (96, 160, dict(gate=True, addend=True)),
    (96, 160, dict(m1=True, m2=True)),
    (6, 64, {}), (64, 66, {})])
def test_f32_dx_refuses_before_the_loader(monkeypatch, n, kout, kw):
    _refused(monkeypatch)
    rng = np.random.default_rng(3)
    side = {s: _r(rng, 9, kout) for s in ("gate", "addend") if kw.get(s)}
    sites = {s: tlt._site(SEED, tag, kout, RATE, torch.float32)
             for s, tag in (("m1", tlt._SITE_FFN_MID),
                            ("m2", tlt._SITE_EMB)) if kw.get(s)}
    with pytest.raises(ValueError, match="dX kernel"):
        tlt._gemm_nt(_r(rng, 9, n), _r(rng, kout, n), **side, **sites)


def _meta_enc(hid, pf):
    def z(*s):
        return torch.empty(s, device="meta")
    return tlf.EncoderLayerParams(
        z(hid, 3 * hid), z(3 * hid), z(hid, hid), z(hid), z(hid), z(hid),
        z(hid, pf), z(pf), z(pf, hid), z(hid))


@pytest.mark.parametrize("stem", [False, True])
def test_training_backward_hands_every_dx_its_pair(monkeypatch, calls, stem):
    """Meta tensors through the float32 K7 backward (the stem-fed layer
    too): every dX call reads its weight's dX pair from the step's one
    pack, and the layer's 4 dX and 4 dW products launch the tensor-core
    kernels."""
    def check_cuda(name, t, dtype, ndim=None):
        assert t.device.type == "meta" and t.dtype == dtype, (name, t)

    monkeypatch.setattr(kernels, "check_cuda", check_cuda)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    seen = []
    real = tlf.gemm_weight

    def gemm_weight(name, w, pair, dtype, nt=False):
        if name == "gemm_nt":
            seen.append((tuple(w.shape), nt, pair is not None and all(
                tuple(h.shape) == tuple(w.shape) for h in pair)))
        return real(name, w, pair, dtype, nt)

    monkeypatch.setattr(tlf, "gemm_weight", gemm_weight)
    hid, pf = 64, 128
    p = _meta_enc(hid, pf)
    x = torch.empty((2, 256, hid), device="meta")
    kernels.reset_launches()
    tlt.encoder_layer_train_bwd_cuda(x, p, 3, x, 2, RATE, True, stem=stem)
    assert sorted(seen) == sorted([((pf, hid), True, True),
                                   ((hid, pf), True, True),
                                   ((hid, hid), True, True),
                                   ((hid, 3 * hid), True, True)])
    assert kernels.launches["gemm_nt_f32"] == 4
    assert kernels.launches["wgrad_f32"] == 4
    names = [n for n, _ in calls]
    assert names.count("nylon_gemm_nt_f32") == 4
    assert names.count("nylon_wgrad_f32") == 4
