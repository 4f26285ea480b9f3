"""K6: the dropout keep mask of the training kernels, and its kernel.

Port of :func:`nylon_amt_tpu.ops.attention.hash_keep_mask`, bit for bit.
The mask is a pure function of an element's GLOBAL index in the
``(n * d1, w)`` view of its site (``w = d2``, or ``d2 / 2`` when ``d2 %
256 == 0`` and each 32-bit hash gives two 16-bit draws), mixed with the
caller's seed and a per-site tag, so the forward and backward kernels
regenerate the same masks in any launch geometry:

* ``lin = row0 * d1 * w + r * w + c`` (mod 2**32), ``x = lin ^ seed *
  0x9E3779B9 ^ tag * 0x85EBCA6B``, then xorshift-multiply
  (``x ^= x >> 16; x *= 0x7FEB352D; x ^= x >> 15; x *= 0x846CA68B``);
* unpacked: keep when ``x >= int(rate * 2**32)``; packed: the low 16 bits
  fill columns ``[0, d2/2)`` and the high 16 bits ``[d2/2, d2)``, keep when
  the draw ``>= round(rate * 65536)``;
* a kept element is ``1 / (1 - rate)`` (of the quantised rate when packed)
  rounded to float32 and then to ``dtype``, a dropped one 0.

:func:`hash_keep_mask_plain` computes it with int64 tensor arithmetic on
any device. :func:`hash_keep_mask` and :func:`apply_keep_mask` are the
wrappers: on a CPU tensor they take the plain version, on a CUDA device
they launch ``csrc/hash_mask.cu`` (the device function of
``csrc/hash_mask.cuh`` that the training kernels call in their epilogues).
"""

from __future__ import annotations

import torch

from nylon_amt_tpu_torch import kernels

_U32 = 0xFFFFFFFF
_SEED_MUL = 0x9E3779B9
_TAG_MUL = 0x85EBCA6B
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def seed_mix(seed: int) -> int:
    """``seed * 0x9E3779B9`` mod 2**32 (the seed as uint32, as JAX casts
    it)."""
    return ((int(seed) & _U32) * _SEED_MUL) & _U32


def site_key(seed: int, tag: int) -> int:
    """The 32-bit word a site's linear index is xor-ed with."""
    return seed_mix(seed) ^ ((int(tag) * _TAG_MUL) & _U32)


def site_constants(rate: float, d2: int, dtype: torch.dtype
                   ) -> tuple[int, float, int]:
    """``(threshold, keep value, half)`` of a site whose rows are ``d2``
    long: ``half`` is ``d2 // 2`` when the draws are packed, else 0."""
    if d2 % 256:
        threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
        inv = 1.0 / (1.0 - rate)
        half = 0
    else:
        threshold = min(max(int(round(rate * 65536)), 1), 65535)
        inv = 65536.0 / (65536.0 - threshold)
        half = d2 // 2
    keep = torch.tensor(inv, dtype=torch.float32).to(dtype).float().item()
    return threshold, keep, half


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2**32 for int64 ``x`` in [0, 2**32), in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_keep_mask_plain(seed: int, tag: int, row0: int, shape, rate: float,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """The keep mask of ``shape = (n, d1, d2)`` on ``device``, by plain
    tensor arithmetic (the JAX function's ``row0`` included)."""
    n, d1, d2 = shape
    threshold, keep, half = site_constants(rate, d2, dtype)
    w = half or d2
    base = (int(row0) * d1 * w) & _U32
    r = torch.arange(n * d1, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    x = ((r * w + c + base) & _U32) ^ site_key(seed, tag)
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)

    def select(v):
        return torch.where(v >= threshold, keep, 0.0).to(torch.float32)

    if not half:
        out = select(x)
    else:
        out = torch.cat([select(x & 0xFFFF), select(x >> 16)], dim=-1)
    return out.to(dtype).reshape(n, d1, d2)


def _launch(x, out, rows: int, d2: int, seed: int, tag: int, row0: int,
            d1: int, rate: float) -> None:
    threshold, keep, half = site_constants(rate, d2, out.dtype)
    base = (int(row0) * d1 * (half or d2)) & _U32
    kernels.call("nylon_hash_mask", None if x is None else x.data_ptr(),
                 out.data_ptr(), rows, d2, site_key(seed, tag), threshold,
                 keep, half, base, int(out.dtype == torch.bfloat16),
                 kernels.stream_of(out))
    kernels.launches["hash_keep_mask"] += 1


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hash_keep_mask: the kernel writes float32 or "
                         f"bfloat16, got {dtype}")


def hash_keep_mask(seed: int, tag: int, row0: int, shape, rate: float,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Dropout keep mask (scaled by ``1 / (1 - rate)``) of ``shape = (n,
    d1, d2)``: the plain version on the CPU, the K6 kernel on a CUDA
    device."""
    device = torch.device(device)
    if device.type == "cpu":
        return hash_keep_mask_plain(seed, tag, row0, shape, rate, dtype)
    _check_dtype(dtype)
    n, d1, d2 = shape
    out = torch.empty(shape, dtype=dtype, device=device)
    with torch.cuda.device(device):
        _launch(None, out, n * d1, d2, seed, tag, row0, d1, rate)
    return out


def apply_keep_mask(x: torch.Tensor, seed: int, tag: int,
                    rate: float) -> torch.Tensor:
    """``x * hash_keep_mask(seed, tag, 0, x.shape, rate, x.dtype)`` for a
    3-D ``x``; on a CUDA tensor one launch of the K6 kernel."""
    if x.device.type == "cpu":
        return x * hash_keep_mask_plain(seed, tag, 0, x.shape, rate, x.dtype)
    _check_dtype(x.dtype)
    kernels.check_cuda("apply_keep_mask: x", x, x.dtype, ndim=3)
    n, d1, d2 = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch(x, out, n * d1, d2, seed, tag, 0, d1, rate)
    return out
