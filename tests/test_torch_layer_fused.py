"""The port's plain layer functions (K2, K3, K4, K5) against the JAX
package's fused layers run in Pallas interpret mode, on the same packed
weights.

f32 at atol/rtol 2e-5. bf16 by the scale-invariant gate of
``tests/test_engine.py``: the port's error from the f32 truth must stay
within twice the JAX bf16 error + 1e-3 (both are rounded truths with
different reduction orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nylon_amt_tpu.ops import layer_fused as jlf
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import layer_fused as tlf

HID, PF, HEADS, N = 32, 64, 2, 3
_F32_FIELDS = ("g", "b")


def _params(rng, cls, with_self=True):
    """Seeded numpy weights for ``cls``'s fields, rounded to bf16 values so
    the f32 truth and the bf16 runs share their inputs exactly."""
    shapes = {"wqkv": (HID, 3 * HID), "bqkv": (3 * HID,),
              "wsqkv": (HID, 3 * HID if with_self else 0),
              "bsqkv": (3 * HID if with_self else 0,),
              "wso": (HID, HID), "bso": (HID,), "wq": (HID, HID),
              "bq": (HID,), "wkv": (HID, 2 * HID), "bkv": (2 * HID,),
              "wo": (HID, HID), "bo": (HID,), "w1": (HID, PF), "b1": (PF,),
              "w2": (PF, HID), "b2": (HID,)}
    out = {}
    for f in cls._fields:
        if f == "g":
            a = 1.0 + 0.1 * rng.standard_normal(HID)
        elif f == "b":
            a = 0.1 * rng.standard_normal(HID)
        elif f.startswith("w"):
            shape = shapes[f]
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            a = 0.1 * rng.standard_normal(shapes[f])
        out[f] = _bf16_values(a)
    return out


def _bf16_values(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _jax(cls, params, dtype):
    return cls(**{f: jnp.asarray(a).astype(jnp.float32 if f in _F32_FIELDS
                                          else dtype)
                  for f, a in params.items()})


def _torch(cls, params, dtype):
    return cls(**{f: torch.from_numpy(a).to(torch.float32 if f in
                                           _F32_FIELDS else dtype)
                  for f, a in params.items()})


def _run(kind, dtype_name, seed=0):
    """(JAX output, port output) for one layer kind at one dtype, as f32
    numpy."""
    rng = np.random.default_rng(seed)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    if kind.startswith("enc"):
        length = int(kind[3:])
        params = _params(rng, jlf.EncoderLayerParams)
        acts = [_bf16_values(rng.standard_normal((N, length, HID)))]
        j_fn = lambda x, p: jlf.encoder_layer(x, p, HEADS, interpret=True)
        t_fn = lambda x, p: tlf.encoder_layer(x, p, HEADS)
        cls_j, cls_t = jlf.EncoderLayerParams, tlf.EncoderLayerParams
    else:
        params = _params(rng, jlf.CrossLayerParams, with_self=kind == "dec")
        acts = [_bf16_values(rng.standard_normal((N, 88, HID))),
                _bf16_values(rng.standard_normal((N, 256, HID)))]
        j_layer = jlf.decoder_layer if kind == "dec" else \
            jlf.decoder_layer_zero
        t_layer = tlf.decoder_layer if kind == "dec" else \
            tlf.decoder_layer_zero
        j_fn = lambda t, e, p: j_layer(t, e, p, HEADS, interpret=True)
        t_fn = lambda t, e, p: t_layer(t, e, p, HEADS)
        cls_j, cls_t = jlf.CrossLayerParams, tlf.CrossLayerParams
    got_j = j_fn(*(jnp.asarray(a).astype(jdt) for a in acts),
                 _jax(cls_j, params, jdt))
    got_t = t_fn(*(torch.from_numpy(a).to(tdt) for a in acts),
                 _torch(cls_t, params, tdt))
    return (np.asarray(got_j.astype(jnp.float32)),
            got_t.float().numpy())


def _run_stem(dtype_name, seed=0):
    """(JAX, port) ``encoder_layer_with_stem`` on seeded frame-major f32
    spectrograms: 2 examples of 8 frames, 256 bins, a 9-tap stem."""
    rng = np.random.default_rng(seed)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    n_frame, n_proc, n_bin = 8, 9, 256
    params = _params(rng, jlf.EncoderLayerParams)
    spec_t = rng.standard_normal((2, n_frame + n_proc - 1, n_bin)).astype(
        np.float32)
    keff = (0.3 * rng.standard_normal((n_proc, HID))).astype(np.float32)
    beff = (0.1 * rng.standard_normal(HID)).astype(np.float32)
    pos = _bf16_values(0.5 * rng.standard_normal((n_bin, HID)))
    got_j = jlf.encoder_layer_with_stem(
        jnp.asarray(spec_t), jnp.asarray(keff), jnp.asarray(beff),
        jnp.asarray(pos).astype(jdt), _jax(jlf.EncoderLayerParams, params, jdt),
        HEADS, n_frame, jdt, interpret=True)
    got_t = tlf.encoder_layer_with_stem(
        torch.from_numpy(spec_t), torch.from_numpy(keff),
        torch.from_numpy(beff), torch.from_numpy(pos).to(tdt),
        _torch(tlf.EncoderLayerParams, params, tdt), HEADS, n_frame, tdt)
    return (np.asarray(got_j.astype(jnp.float32)),
            got_t.float().numpy())


KINDS = ["stem", "enc256", "enc128", "dec_zero", "dec"]


def _run_kind(kind, dtype_name):
    return _run_stem(dtype_name) if kind == "stem" else _run(kind, dtype_name)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_layer_matches_jax_f32(kind):
    got_j, got_t = _run_kind(kind, "f32")
    assert got_t.shape == got_j.shape
    np.testing.assert_allclose(got_t, got_j, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_layer_bf16_gate(kind):
    truth, _ = _run_kind(kind, "f32")
    got_j, got_t = _run_kind(kind, "bf16")
    scale = np.maximum(np.abs(truth), 1.0)
    e_jax = np.max(np.abs(got_j - truth) / scale)
    e_port = np.max(np.abs(got_t - truth) / scale)
    assert e_port <= 2.0 * e_jax + 1e-3, (kind, e_port, e_jax)


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    rng = np.random.default_rng(1)
    p = _torch(tlf.EncoderLayerParams, _params(rng, jlf.EncoderLayerParams),
               torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, 128, HID)).astype(
        np.float32))
    before = dict(kernels.launches)
    np.testing.assert_array_equal(tlf.encoder_layer(x, p, HEADS).numpy(),
                                  tlf.encoder_layer_plain(x, p, HEADS).numpy())
    assert kernels.launches == before
