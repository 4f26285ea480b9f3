"""The LayerNorm backward of the training layers (``csrc/
layer_fused_train.cu``'s ``ln_bwd_kernel``, ``nylon_ln_bwd[_f32]``) on the
CPU, in a few seconds:

1. Its plain twin ``ln_bwd_plain`` against the JAX package's ``_ln_fwd``
   statistics and ``_ln_bwd`` in f32, on seeded numpy inputs, at N = 64,
   96 and 256, with and without a dropout site (the mask JAX's
   ``hash_keep_mask``): da, dam, dgamma and dbeta within 1e-6 of max
   |JAX|.
2. The kernel route on meta tensors (the entry points recorded, nothing
   launched): a fused bf16 training step at the paper's layer counts calls
   ``nylon_ln_bwd`` twice an encoder-type layer, twice for
   ``decoder_layer_zero`` and three times a decoder layer (20), the
   default f32 step ``nylon_ln_bwd_f32`` as often (13), each at its
   layer's rows, and every call's grid (one or two blocks an SM, block b
   taking the tiles b, b + blocks, ..) covers every row with no block
   idle.
3. The wrappers refuse with ``ValueError``, before any call, what the
   kernel does not take: N % 32, N > 256, s unlike dy, rows that are not
   contiguous, a misaligned start.
4. ``ln_bwd_layout``: no lane idles at the default, hid-96 and paper
   widths in either dtype.
5. The reduction of the partial sums (``reduce_rows_kernel``,
   ``nylon_reduce_rows``): ``reduce_rows_plain`` is a numpy f32 loop in
   row order bit for bit; ``reduce_rows_plan``'s tiles cover every column;
   ``_weight_grad`` and ``_LnGrads.reduce`` each make one call with both
   segments; a fused step's calls are ``reduce_step_segments``' (52 at
   the paper's layer counts, 34 at the default's); the wrapper refuses
   what the kernel does not take before any call.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu.ops import attention as jatt
from nylon_amt_tpu.ops import layer_fused_train as jlt
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.config import Config, ModelConfig
from nylon_amt_tpu_torch.models import fused_train
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

M, SEED, RATE, TAG = 203, 13_579, 0.1, tlt._SITE_FFN_OUT
TOL = 1e-6   # of max |JAX|, f32
SMS = 132    # an H100's


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the plain twin vs JAX --

@pytest.mark.parametrize("n", [64, 96, 256])
@pytest.mark.parametrize("drop", [False, True])
def test_ln_bwd_plain_matches_jax_f32(n, drop):
    rng = np.random.default_rng(n + drop)
    s = (rng.standard_normal((M, n)) * 3 + 0.5).astype(np.float32)
    dy = rng.standard_normal((M, n)).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(n)).astype(np.float32)
    _, xhat, inv = jlt._ln_fwd(jnp.asarray(s), jnp.asarray(g),
                               jnp.zeros(n, jnp.float32))
    dx, dg, db = jlt._ln_bwd(jnp.asarray(dy), xhat, inv, jnp.asarray(g))
    want = [dx, None, dg, db]
    if drop:
        keep = jatt.hash_keep_mask(jnp.int32(SEED), TAG, 0, (1, M, n), RATE,
                                   jnp.float32)[0]
        want[1] = dx * keep
    site = tlt._site(SEED, TAG, n, RATE, torch.float32) if drop else None
    got = tlt.ln_bwd_plain(torch.from_numpy(dy), torch.from_numpy(s),
                           torch.from_numpy(g), site)
    assert (got[1] is None) == (not drop)
    for name, a, b in zip(("da", "dam", "dg", "db"), got, want):
        if b is None:
            continue
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        err = np.abs(a.numpy() - b).max()
        assert err <= TOL * np.abs(b).max(), (name, err)


# ------------------------------------------ the route on meta tensors --

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
    monkeypatch.setattr(tlt, "_sm_count", lambda index: SMS)
    return seen


def _step_calls(cfg, calls, name):
    """The LayerNorm backward calls of one fused training step of ``cfg``
    on meta tensors (batch 1), as (M, N, rows a tile, blocks)."""
    model = HFT(cfg, "meta")
    spec = torch.zeros((1, cfg.feature.n_bins, cfg.input.margin_b
                        + cfg.input.num_frame + cfg.input.margin_f),
                       device="meta")
    seeds = dict.fromkeys(fused_train.seed_slots(cfg), 5)
    out = fused_train.train_forward(model, spec, seeds)
    kernels.reset_launches()
    sum(v.float().sum() for v in out.values()).backward()
    got = [a[7:11] for n, a in calls if n == name]
    assert kernels.launches["ln_bwd"] == len(got)
    assert not any(n.startswith("nylon_ln_bwd") and n != name
                   for n, _ in calls)
    return got


def _want_rows(cfg):
    """The rows of each LayerNorm backward of a batch-1 step: two a
    frequency or time encoder layer, two for decoder_layer_zero, three a
    decoder layer."""
    m, i = cfg.model, cfg.input
    freq = i.num_frame * cfg.feature.n_bins
    note = i.num_frame * cfg.midi.num_note    # the decoder's and time's
    return sorted([freq] * 2 * m.enc_layer + [note] * (
        2 * m.dec_layer + 2 + 3 * (m.dec_layer - 1)))


@pytest.mark.parametrize("which", ["paper bf16", "default f32"])
def test_train_step_calls_the_ln_backward_once_a_layernorm(calls, which):
    if which == "paper bf16":
        cfg = Config(model=dataclasses.replace(ModelConfig.paper_scale(),
                                               compute_dtype="bfloat16"))
        name, count, dtype = "nylon_ln_bwd", 20, torch.bfloat16
    else:
        cfg = Config()
        name, count, dtype = "nylon_ln_bwd_f32", 13, torch.float32
    got = _step_calls(cfg, calls, name)
    assert len(got) == count == len(_want_rows(cfg))
    assert sorted(m for m, _, _, _ in got) == _want_rows(cfg)
    hid = cfg.model.hid_dim
    for m, n, rows, blocks in got:
        kc, _, want_rows = tlt.ln_bwd_layout(n, dtype)
        assert n == hid and rows == want_rows
        tiles = -(-m // rows)
        # block b takes tiles b, b + blocks, ..: all rows, no block idle;
        # two blocks an SM where a lane holds one chunk
        assert 0 < blocks <= min((2 if kc == 1 else 1) * SMS, tiles)
        assert tiles * rows >= m > (tiles - 1) * rows


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _refusals():
    """(what is wrong, dy, s) the kernel does not take."""
    wide = _meta((64, 2 * 160))
    return [
        ("N % 32", _meta((64, 80)), _meta((64, 80))),
        ("N > 256", _meta((64, 288)), _meta((64, 288))),
        ("s unlike dy", _meta((64, 96)), _meta((64, 64))),
        ("dtype", _meta((64, 96)), _meta((64, 96), torch.float32)),
        ("f16", _meta((64, 96), torch.float16),
         _meta((64, 96), torch.float16)),
        ("strided rows", wide[:, :160], _meta((64, 160))),
        ("misaligned start", _meta((65 * 96,))[4:4 + 64 * 96].view(64, 96),
         _meta((64, 96))),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_ln_bwd_wrappers_refuse_before_any_call(calls, case):
    what, dy, s = _refusals()[case]
    g = torch.empty(dy.shape[1], dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tlt.ln_bwd_cuda(dy, s, g)
    ln = tlt._LnGrads(dy.shape[0], 96, 1, dy.device, torch.bfloat16)
    with pytest.raises(ValueError):
        tlt._ln_backward(dy, s, g, None, ln)
    assert calls == [], what


def test_ln_bwd_cuda_takes_the_step_widths(calls):
    for n, dtype in ((64, torch.float32), (96, torch.bfloat16),
                     (256, torch.bfloat16), (256, torch.float32)):
        dy, s = _meta((1000, n), dtype), _meta((1000, n), dtype)
        g = torch.empty(n, dtype=torch.float32, device="meta")
        site = tlt._site(SEED, TAG, n, RATE, dtype)
        da, dam, dg, db = tlt.ln_bwd_cuda(dy, s, g, site)
        assert da.shape == dam.shape == dy.shape and dg.shape == (n,)
    assert [name for name, _ in calls] == [
        "nylon_ln_bwd_f32", "nylon_reduce_rows",
        "nylon_ln_bwd", "nylon_reduce_rows",
        "nylon_ln_bwd", "nylon_reduce_rows",
        "nylon_ln_bwd_f32", "nylon_reduce_rows"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [64, 96, 256])
def test_ln_bwd_layout_idles_no_lane_at_the_model_widths(dtype, n):
    kc, lanes, rows = tlt.ln_bwd_layout(n, dtype)
    per_chunk = 16 // dtype.itemsize
    assert kc in (1, 2, 3) and lanes in (1, 2, 4, 8, 16, 32)
    assert kc * lanes * per_chunk == n            # every lane busy
    assert rows == tlt._LN_WARPS * 32 // lanes    # a row group a warp


# ------------------------------------------ the partial-sum reduction --

@pytest.mark.parametrize("p,n", [(1, 7), (11, 300), (528, 256), (33, 64)])
def test_reduce_rows_plain_adds_in_row_order(p, n):
    rng = np.random.default_rng(p * n)
    parts = (rng.standard_normal((p, n)) * 10.0 ** rng.integers(
        -3, 4, (p, n))).astype(np.float32)
    want = np.zeros(n, np.float32)
    for row in parts:
        want = (want + row).astype(np.float32)
    got = tlt.reduce_rows_plain([torch.from_numpy(parts)])[0]
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("p,n", [(11, 196608), (22, 768), (528, 256),
                                 (792, 64), (131, 8192), (5, 10), (1, 4)])
def test_reduce_rows_plan_tiles_every_column(p, n):
    cols, blocks = tlt.reduce_rows_plan(p, n)
    assert cols & (cols - 1) == 0 and tlt._RED_MIN_COLS <= cols <= \
        tlt._RED_MAX_COLS
    assert blocks * cols >= n > (blocks - 1) * cols
    # a block takes about _RED_BLOCK_BYTES of partials where tiles allow
    assert p * cols * 4 <= 2 * tlt._RED_BLOCK_BYTES or \
        cols == tlt._RED_MIN_COLS


def _segments(args):
    """The (P, n, cols) of each segment of a ``nylon_reduce_rows`` call."""
    segs = [args[5 * i + 2:5 * i + 5] for i in range(2)]
    return [s for s, ptr in zip(segs, (args[0], args[5])) if ptr is not None]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_weight_grad_reduces_weight_and_bias_in_one_launch(calls, dtype):
    m, ka, n = 5000, 256, 768
    kernels.reset_launches()
    dw, db = tlt._weight_grad(_meta((m, ka), dtype), _meta((m, n), dtype))
    assert dw.shape == (ka, n) and db.shape == (n,)
    assert [name for name, _ in calls] == [
        "nylon_wgrad" + ("" if dtype == torch.bfloat16 else "_f32"),
        "nylon_reduce_rows"]
    assert kernels.launches["reduce_rows"] == 1
    bm, _, _, chunks = tlt.wgrad_layout(m, ka, n, dtype, SMS)
    want = [(chunks, ka * n), (chunks * -(-ka // bm), n)]
    assert _segments(calls[1][1]) == [
        (p, k, tlt.reduce_rows_plan(p, k)[0]) for p, k in want]


def test_ln_grads_reduce_dgamma_and_dbeta_in_one_launch(calls):
    ln = tlt._LnGrads(90112, 256, 3, torch.device("meta"), torch.bfloat16)
    kernels.reset_launches()
    dg, db = ln.reduce()
    assert dg.shape == db.shape == (256,)
    assert [name for name, _ in calls] == ["nylon_reduce_rows"]
    assert kernels.launches["reduce_rows"] == 1
    p = 3 * tlt.ln_bwd_plan(90112, 256, torch.bfloat16, SMS)[1]
    assert _segments(calls[0][1]) == [(p, 256, 8)] * 2


def test_reduce_refuses_before_any_call(calls):
    f32 = _meta((4, 64), torch.float32)
    for parts in ((), (f32, f32, f32), (_meta((4, 64)),),
                  (_meta((4, 128), torch.float32)[:, :64],),
                  (_meta((4 * 64 + 1,), torch.float32)[1:].view(4, 64),),
                  (_meta((0, 64), torch.float32),)):
        with pytest.raises(ValueError):
            tlt._reduce(*parts)
    assert calls == []


@pytest.mark.parametrize("which", ["paper bf16", "default f32"])
def test_train_step_reduces_once_a_dw_product_and_a_layer(calls, which):
    from nylon_amt_tpu_torch.tools.gemm_ab import reduce_step_segments

    if which == "paper bf16":
        cfg = Config(model=dataclasses.replace(ModelConfig.paper_scale(),
                                               compute_dtype="bfloat16"))
        name, dtype = "nylon_ln_bwd", torch.bfloat16
    else:
        cfg, name, dtype = Config(), "nylon_ln_bwd_f32", torch.float32
    _step_calls(cfg, calls, name)
    got = sorted(tuple((p, n) for p, n, _ in _segments(a))
                 for n_, a in calls if n_ == "nylon_reduce_rows")
    assert kernels.launches["reduce_rows"] == len(got)
    want = sorted(tuple(segs) for _, segs, count in reduce_step_segments(
        cfg.model, dtype, SMS, batch=1) for _ in range(count))
    assert got == want and len(got) == (52 if which == "paper bf16" else 34)
