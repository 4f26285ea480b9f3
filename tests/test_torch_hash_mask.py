"""K6's standalone mask kernel (``csrc/hash_mask.cu``, ``nylon_hash_mask``)
on the CPU, in a few seconds:

1. ``hash_mask_plan`` and its walk (``hash_mask_walk``, the kernel's
   thread-by-thread order: flat vectors and a scalar tail unpacked, the
   packed pairs (c, c + d2/2) stepped with a carry) cover every element
   of a ``(rows, d2)`` view exactly once, for d2 in {64, 88, 96, 128,
   256, 512} and a few odd widths, bf16 and f32, on grids of one wave or
   many passes.
2. The walk's linear indices, hashed (``hash32``, ``csrc/hash_mask.cuh``'s
   ``hash_mix``) and drawn as the kernel draws them, give
   ``hash_keep_mask_plain``'s masks bit for bit (a ``row0`` included), and
   JAX's ``hash_keep_mask`` at two small shapes, one packed and one not.
3. The wrappers on meta tensors (the entry point recorded, nothing
   launched): one ``nylon_hash_mask`` call with the site's constants, and
   a ``ValueError`` before any call for an f16, misaligned or
   non-contiguous input.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu.ops import attention as jatt
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import attention as att

SEED, TAG, RATE = 24_680, 5, 0.1
SMS = 132    # an H100's


def _masks(plan, rows, d2, dtype, row0=0, seed=SEED, tag=TAG):
    """The keep mask the kernel writes by ``plan``: its walk's indices
    hashed and drawn."""
    threshold, keep, half = att.site_constants(RATE, d2, dtype)
    base = (row0 * rows * (half or d2)) & 0xFFFFFFFF
    lin, lo, hi = att.hash_mask_walk(plan, rows, d2, base)
    x = att.hash32(lin, att.site_key(seed, tag))
    out = torch.zeros(rows * d2, dtype=torch.float32)
    if half:
        out[lo] = torch.where((x & 0xFFFF) >= threshold, keep, 0.0)
        out[hi] = torch.where((x >> 16) >= threshold, keep, 0.0)
    else:
        out[lo] = torch.where(x >= threshold, keep, 0.0)
    return out.view(rows, d2).to(dtype)


# ------------------------------------------------------ the plan's walk --

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d2", [64, 88, 96, 128, 256, 512, 7, 768])
@pytest.mark.parametrize("grid", [(SMS, 8), (1, 1)])
def test_hash_mask_plan_covers_every_element_once(dtype, d2, grid):
    rows = 45
    plan = att.hash_mask_plan(rows, d2, dtype, *grid)
    assert plan.vec * dtype.itemsize == 16
    assert 1 <= plan.blocks <= grid[0] * grid[1]
    lin, lo, hi = att.hash_mask_walk(plan, rows, d2)
    if d2 % 256 == 0:                       # one hash a pair (c, c + d2/2)
        assert plan.half == d2 // 2 and plan.tail == 0
        assert plan.items == rows * plan.width
        assert torch.equal(hi, lo + d2 // 2)
        assert bool(((lo % d2) < d2 // 2).all())
        written = torch.cat([lo, hi])
    else:                                   # flat vectors, a scalar tail
        assert plan.half == 0 and bool((hi == -1).all())
        assert plan.items * plan.vec + plan.tail == rows * d2
        assert torch.equal(lin, lo)
        written = lo
    assert torch.equal(written.sort().values, torch.arange(rows * d2))
    assert len(lin) == len(lo)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d2,row0", [(37, 256, 0), (5, 512, 3),
                                          (41, 88, 0), (13, 96, 2),
                                          (9, 7, 0)])
def test_hash_mask_walk_draws_the_plain_masks(dtype, rows, d2, row0):
    for grid in ((2, 1), (SMS, 8)):
        plan = att.hash_mask_plan(rows, d2, dtype, *grid)
        want = att.hash_keep_mask_plain(SEED, TAG, row0, (1, rows, d2), RATE,
                                        dtype)[0]
        got = _masks(plan, rows, d2, dtype, row0)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("rows,d2", [(24, 256), (19, 88)])
def test_hash_mask_walk_draws_jax_masks(rows, d2):
    plan = att.hash_mask_plan(rows, d2, torch.float32, 2, 1)
    got = _masks(plan, rows, d2, torch.float32, row0=1)
    want = np.asarray(jatt.hash_keep_mask(jnp.int32(SEED), TAG, 1,
                                          (1, rows, d2), RATE,
                                          jnp.float32))[0]
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------- the route on meta --

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


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("d2,dtype", [(256, torch.bfloat16),
                                      (88, torch.float32)])
def test_mask_wrappers_call_the_entry_point_once(calls, d2, dtype):
    kernels.reset_launches()
    out = att.apply_keep_mask(_meta((4, 11, d2), dtype), SEED, TAG, RATE)
    mask = att.hash_keep_mask(SEED, TAG, 2, (4, 11, d2), RATE, dtype, "meta")
    assert out.shape == mask.shape == (4, 11, d2)
    assert kernels.launches["hash_keep_mask"] == 2
    threshold, keep, half = att.site_constants(RATE, d2, dtype)
    w = half or d2
    for (name, args), base in zip(calls, (0, 2 * 11 * w)):
        assert name == "nylon_hash_mask"
        assert args[2:] == (44, d2, att.site_key(SEED, TAG), threshold, keep,
                            half, base, int(dtype == torch.bfloat16), 0)
    assert calls[0][1][0] is not None and calls[1][1][0] is None


def _refusals():
    """(what is wrong, x) the kernel does not take."""
    return [
        ("f16", _meta((2, 8, 256), torch.float16)),
        ("misaligned start", _meta((2 * 8 * 256 + 4,))[4:].view(2, 8, 256)),
        ("strided rows", _meta((2, 8, 512))[:, :, :256]),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())))
def test_mask_wrappers_refuse_before_any_call(calls, case):
    what, x = _refusals()[case]
    with pytest.raises(ValueError):
        att.apply_keep_mask(x, SEED, TAG, RATE)
    assert calls == [], what


def test_hash_keep_mask_refuses_f16_before_any_call(calls):
    with pytest.raises(ValueError):
        att.hash_keep_mask(SEED, TAG, 0, (2, 8, 256), RATE, torch.float16,
                           "meta")
    assert calls == []
