"""The port's training layers (K6 mask, K7/K8/K9 plain twins and their
autograd Functions) against the JAX package's custom-VJP kernels run in
Pallas interpret mode, on the same seeded weights, inputs and dropout seeds.

* K6: the keep mask is bit-identical (``torch.equal``) to JAX's.
* K7/K8/K9 in f32: forward at atol = rtol = 2e-5; ``dx``/``dtrg``/``denc``
  and every weight gradient at 5e-4 after scaling by the largest |grad|
  (``tests/test_layer_fused_train.py``'s tolerance), with dropout 0 and
  0.1. L = 256 frequency bins, so the probability masks take the packed
  16-bit branch; pf = 256 does the same for the FFN mask.
* bf16: the scale-invariant gate of ``tests/test_torch_model.py``: the
  port's error from the f32 truth within twice JAX's bf16 error + 1e-3.
"""

import functools
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
from nylon_amt_tpu.ops import layer_fused_train as jlt
from nylon_amt_tpu.ops.layer_fused import EncoderLayerParams as JEnc
from nylon_amt_tpu_torch import kernels
from nylon_amt_tpu_torch.ops import attention as tatt
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

N, LQ, LK, HID, PF, HEADS = 2, 88, 256, 32, 256, 2
HERE = Path(__file__).resolve().parent
SEED = 1_234_567


# ------------------------------------------------------------------- K6 --

@pytest.mark.parametrize("d2", [16, 88, 128, 256, 512])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hash_keep_mask_is_bit_identical(d2, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    shape = (3, 5, d2)
    cases = [(0, 0, 0), (12345, 3, 7), (2 ** 31 - 2, (4 + 8) * 64 + 3, 0),
             # row0 * d1 * w wraps 2**32
             (987654321, 6, 2 ** 31 // 3)]
    for rate in (0.1, 0.5):
        for seed, tag, row0 in cases:
            want = jatt.hash_keep_mask(jnp.int32(seed), tag, row0, shape,
                                       rate, jdt)
            got = tatt.hash_keep_mask(seed, tag, row0, shape, rate, tdt)
            want = torch.from_numpy(np.array(want.astype(jnp.float32)))
            assert got.dtype == tdt
            assert torch.equal(got.float(), want), (rate, seed, tag, row0)


def test_apply_keep_mask_is_x_times_mask():
    x = torch.randn(2, 7, 256, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    got = tatt.apply_keep_mask(x, 99, tlt._SITE_EMB, 0.1)
    want = x * tatt.hash_keep_mask_plain(99, tlt._SITE_EMB, 0,
                                         tuple(x.shape), 0.1, x.dtype)
    assert torch.equal(got, want)
    kept = (got != 0) | (x == 0)
    assert 0.85 < kept.float().mean().item() < 0.95


# --------------------------------------------------------------- layers --

def _weights(rng, fields):
    shapes = {"wqkv": (HID, 3 * HID), "bqkv": (3 * HID,),
              "wsqkv": (HID, 3 * HID), "bsqkv": (3 * HID,),
              "wso": (HID, HID), "bso": (HID,), "wq": (HID, HID),
              "bq": (HID,), "wkv": (HID, 2 * HID), "bkv": (2 * HID,),
              "wo": (HID, HID), "bo": (HID,), "w1": (HID, PF), "b1": (PF,),
              "w2": (PF, HID), "b2": (HID,)}
    out = {}
    for f in fields:
        if f == "g":
            a = 1.0 + 0.1 * rng.standard_normal(HID)
        elif f == "b":
            a = 0.1 * rng.standard_normal(HID)
        elif f.startswith("w"):
            a = rng.standard_normal(shapes[f]) / np.sqrt(shapes[f][0])
        else:
            a = 0.1 * rng.standard_normal(shapes[f])
        # bf16 values, so that the f32 truth and the bf16 runs share inputs
        out[f] = np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                            .astype(jnp.float32))
    return out


KINDS = {"enc": (JEnc, tlf.EncoderLayerParams),
         "dec_zero": (jlt.DecZeroParams, tlt.DecZeroParams),
         "dec": (jlt.DecLayerParams, tlt.DecLayerParams)}


def _bf16_values(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _run(kind, rate, emb_drop, dtype, seed=0):
    """(JAX, port) ``(out, input grads, weight grads)`` as f32 numpy, for a
    loss sum(out * co)."""
    rng = np.random.default_rng(seed)
    jcls, tcls = KINDS[kind]
    w = _weights(rng, jcls._fields)
    if kind == "enc":
        acts = [_bf16_values(rng.standard_normal((N, LK, HID)))]
    else:
        acts = [_bf16_values(rng.standard_normal((N, LQ, HID))),
                _bf16_values(rng.standard_normal((N, LK, HID)))]
    co = rng.standard_normal(acts[0].shape).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    jp = jcls(**{f: jnp.asarray(a) for f, a in w.items()})
    jin = [jnp.asarray(a).astype(jdt) for a in acts]
    if kind == "enc":
        jfn = lambda x, p: jlt.encoder_layer_train(
            x, p, jnp.int32(SEED), HEADS, rate, True, emb_drop)
    else:
        layer = (jlt.decoder_layer_train if kind == "dec"
                 else jlt.decoder_layer_zero_train)
        jfn = lambda t, e, p: layer(t, e, p, jnp.int32(SEED), HEADS, rate,
                                    True)
    jco = jnp.asarray(co)
    out_j, vjp = jax.vjp(jfn, *jin, jp)
    jgrads = vjp(jco.astype(out_j.dtype))

    tp = tcls(**{f: torch.tensor(a, requires_grad=True)
                 for f, a in w.items()})
    tin = [torch.tensor(a).to(tdt).requires_grad_() for a in acts]
    if kind == "enc":
        out_t = tlt.encoder_layer_train(tin[0], tp, SEED, HEADS, rate,
                                        emb_drop)
    else:
        layer = (tlt.decoder_layer_train if kind == "dec"
                 else tlt.decoder_layer_zero_train)
        out_t = layer(tin[0], tin[1], tp, SEED, HEADS, rate)
    out_t.backward(torch.from_numpy(co).to(out_t.dtype))

    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    j = (f32(out_j), [f32(g) for g in jgrads[:-1]],
         {f: f32(g) for f, g in zip(jcls._fields, jgrads[-1])})
    t = (out_t.detach().float().numpy(), [x.grad.float().numpy() for x in tin],
         {f: getattr(tp, f).grad.numpy() for f in tcls._fields})
    return j, t


CASES = [("enc", 0.0, False), ("enc", 0.1, False), ("enc", 0.0, True),
         ("enc", 0.1, True), ("dec_zero", 0.0, False),
         ("dec_zero", 0.1, False), ("dec", 0.0, False), ("dec", 0.1, False)]


def _scaled_close(got, want, name):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-4,
                               err_msg=name)


@pytest.mark.parametrize("kind,rate,emb_drop", CASES)
def test_train_layer_matches_jax_f32(kind, rate, emb_drop):
    (oj, ij, wj), (ot, it, wt) = _run(kind, rate, emb_drop, "f32")
    assert ot.shape == oj.shape
    np.testing.assert_allclose(ot, oj, atol=2e-5, rtol=2e-5)
    for name, a, b in zip(("dx/dtrg", "denc"), it, ij):
        _scaled_close(a, b, name)
    assert set(wt) == set(wj)
    for f in wj:
        assert wt[f].dtype == np.float32
        _scaled_close(wt[f], wj[f], f"d{f}")


def _bf16_gate_errors(kind, emb_drop):
    """``[(name, port error, JAX error)]`` from the f32 truth (same masks)
    at bf16 with dropout 0.1, for the output and every gradient; errors are
    relative to max(|truth|, 1), weight gradients first scaled by their
    largest |truth|."""
    truth, _ = _run(kind, 0.1, emb_drop, "f32")
    j16, t16 = _run(kind, 0.1, emb_drop, "bf16")

    def err(got, ref):
        return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))

    rows = [("out", err(t16[0], truth[0]), err(j16[0], truth[0]))]
    for i, ref in enumerate(truth[1]):
        rows.append((f"input grad {i}", err(t16[1][i], ref),
                     err(j16[1][i], ref)))
    for f, ref in truth[2].items():
        s = max(1.0, float(np.max(np.abs(ref))))
        rows.append((f"d{f}", err(t16[2][f] / s, ref / s),
                     err(j16[2][f] / s, ref / s)))
    return rows


GATE_CASES = [("enc", True), ("dec_zero", False), ("dec", False)]


@functools.lru_cache(maxsize=1)
def _bf16_gate_rows():
    """``_bf16_gate_errors`` of every case, from one fresh interpreter.

    XLA's CPU compiler keeps excess precision across bf16 casts by default
    (``--xla_allow_excess_precision``), so in this process the JAX kernels
    would round at fewer points than their code states. The comparison runs
    in an interpreter with that flag off, where JAX rounds where its code
    casts, the points the port reproduces."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(HERE)!r})\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_layer_fused_train as t\n"
            "print(json.dumps({f'{k}-{e}': t._bf16_gate_errors(k, e)"
            " for k, e in t.GATE_CASES}))\n")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind,emb_drop", GATE_CASES)
def test_train_layer_bf16_gate(kind, emb_drop):
    """bf16 with dropout 0.1: the port's error from the f32 truth within
    twice JAX's bf16 error + 1e-3, for the output and every gradient."""
    rows = _bf16_gate_rows()[f"{kind}-{emb_drop}"]
    assert len(rows) > 10
    for name, e_port, e_jax in rows:
        assert e_port <= 2.0 * e_jax + 1e-3, (kind, name, e_port, e_jax)


def test_rate0_forward_equals_inference_layers():
    """At rate 0 the training forwards are the inference layers (as
    ``tests/test_layer_fused_train.py`` pins for JAX)."""
    rng = np.random.default_rng(3)
    enc_w = _weights(rng, tlf.EncoderLayerParams._fields)
    ep = tlf.EncoderLayerParams(**{f: torch.tensor(a)
                                   for f, a in enc_w.items()})
    x = torch.from_numpy(_bf16_values(rng.standard_normal((N, LK, HID))))
    assert torch.equal(tlt.encoder_layer_train(x, ep, 5, HEADS, 0.0, True),
                       tlf.encoder_layer_plain(x, ep, HEADS))
    dec_w = _weights(rng, tlt.DecLayerParams._fields)
    trg = torch.from_numpy(_bf16_values(rng.standard_normal((N, LQ, HID))))
    enc = torch.from_numpy(_bf16_values(rng.standard_normal((N, LK, HID))))
    dp = tlt.DecLayerParams(**{f: torch.tensor(a)
                               for f, a in dec_w.items()})
    cp = tlf.CrossLayerParams(**dp._asdict())
    assert torch.equal(tlt.decoder_layer_train(trg, enc, dp, 5, HEADS, 0.0),
                       tlf.decoder_layer_plain(trg, enc, cp, HEADS))
    zp = tlt.DecZeroParams(**{f: getattr(dp, f)
                              for f in tlt.DecZeroParams._fields})
    assert torch.equal(
        tlt.decoder_layer_zero_train(trg, enc, zp, 5, HEADS, 0.0),
        tlf.decoder_layer_zero_plain(trg, enc, cp, HEADS))


def test_cpu_training_layers_count_no_launch():
    rng = np.random.default_rng(4)
    w = _weights(rng, tlf.EncoderLayerParams._fields)
    p = tlf.EncoderLayerParams(**{f: torch.tensor(a, requires_grad=True)
                                  for f, a in w.items()})
    x = torch.randn(N, 128, HID, requires_grad=True)
    before = dict(kernels.launches)
    tlt.encoder_layer_train(x, p, 7, HEADS, 0.1, True).sum().backward()
    assert kernels.launches == before
    assert x.grad is not None and p.wqkv.grad is not None
