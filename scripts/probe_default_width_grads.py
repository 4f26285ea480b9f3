"""Probe: how closely the port's training gradients can match the JAX
package's at the default ``ModelConfig()`` (hid 64 over 2 heads, pf 128)
with dropout 0.1, and why the whole-model comparison is made on short
windows. Runs on the CPU (JAX's Pallas kernels in interpret mode, the
port's plain versions) and prints three tables:

1. each JAX training layer at 128 sequences: its custom-VJP backward
   against ``jax.vjp`` through the same forward body traced as plain JAX
   (one grid step, so the dropout masks are the kernel's);
2. each port training layer against the JAX one at 128 sequences (the
   port's autograd Function, i.e. its analytic backward);
3. the whole train step at 16 and 128 frames a window, dropout 0 and
   0.1: the port's gradient against JAX's, and against itself with every
   weight moved by 1e-7 of its value (how far f32 rounding alone moves
   that gradient). Gaps are max |a - b| / max(1, max |b|) over the
   parameters, the measure of ``tests/test_torch_model.py``.

Usage: JAX_PLATFORMS=cpu python scripts/probe_default_width_grads.py
(about two minutes).
"""

from __future__ import annotations

import os
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import jax
import jax.numpy as jnp

from nylon_amt_tpu.config import Config, InputConfig, ModelConfig
from nylon_amt_tpu.models import fused_train as jft
from nylon_amt_tpu.models.hft import init_params
from nylon_amt_tpu.ops import layer_fused_train as jlt
from nylon_amt_tpu.ops.layer_fused import EncoderLayerParams as JEnc
from nylon_amt_tpu.train import step as jstep
from nylon_amt_tpu_torch import config as tconfig
from nylon_amt_tpu_torch.models import fused_train as tft
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.ops import layer_fused as tlf
from nylon_amt_tpu_torch.ops import layer_fused_train as tlt
from nylon_amt_tpu_torch.train import step as tstep

M = ModelConfig()
HID, PF, HEADS, RATE, SEED = M.hid_dim, M.pf_dim, M.enc_head, 0.1, 1_234_567
KINDS = {"enc": (JEnc, tlf.EncoderLayerParams),
         "dec_zero": (jlt.DecZeroParams, tlt.DecZeroParams),
         "dec": (jlt.DecLayerParams, tlt.DecLayerParams)}


def gap(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def layer_inputs(kind, n, rng):
    shapes = tlf.weight_shapes(HID, PF)
    w = {}
    for f in KINDS[kind][0]._fields:
        if f == "g":
            a = 1.0 + 0.1 * rng.standard_normal(HID)
        elif f.startswith("w"):
            a = rng.standard_normal(shapes[f]) / np.sqrt(shapes[f][0])
        else:
            a = 0.1 * rng.standard_normal(shapes[f])
        w[f] = np.asarray(a, np.float32)
    lq = 256 if kind == "enc" else 88
    acts = [rng.standard_normal((n, lq, HID)).astype(np.float32)]
    if kind != "enc":
        acts.append(rng.standard_normal((n, 256, HID)).astype(np.float32))
    dz = rng.standard_normal(acts[0].shape).astype(np.float32)
    return w, acts, dz


def jax_layer(kind):
    """(custom-VJP layer, the same forward body as plain JAX) of a kind."""
    seed_ref = jnp.full((1, 1), SEED, jnp.int32)
    scale = 1.0 / float(HID // HEADS) ** 0.5
    if kind == "enc":
        return (lambda x, p: jlt.encoder_layer_train(
                    x, p, jnp.int32(SEED), HEADS, RATE, True),
                lambda x, p: jlt._enc_train_fwd_body(
                    x, tuple(p), HEADS, scale, RATE, True, seed_ref))
    layer = (jlt.decoder_layer_zero_train if kind == "dec_zero"
             else jlt.decoder_layer_train)

    def body(t, e, p):
        drop = jlt._drop_fn(seed_ref, t.shape[0], RATE)
        if kind == "dec":
            t = jlt._self_prologue_fwd(t, p.wsqkv, p.bsqkv, p.wso, p.bso, p.g,
                                       p.b, HEADS, scale, RATE, True, drop)
        return jlt._cross_tail_fwd_body(
            t, e, p.wq, p.bq, p.wkv, p.bkv, p.wo, p.bo, p.g, p.b, p.w1, p.b1,
            p.w2, p.b2, HEADS, scale, RATE, True, drop)

    return (lambda t, e, p: layer(t, e, p, jnp.int32(SEED), HEADS, RATE,
                                  True), body)


def port_layer(kind, acts, p):
    if kind == "enc":
        return tlt.encoder_layer_train(acts[0], p, SEED, HEADS, RATE)
    layer = (tlt.decoder_layer_zero_train if kind == "dec_zero"
             else tlt.decoder_layer_train)
    return layer(*acts, p, SEED, HEADS, RATE)


def layers(n: int = 128) -> None:
    print(f"layers at hid {HID}, pf {PF}, {HEADS} heads, dropout {RATE}, "
          f"{n} sequences (gaps: output max abs; grads scaled)")
    for kind, (jcls, tcls) in KINDS.items():
        w, acts, dz = layer_inputs(kind, n, np.random.default_rng(0))
        custom, body = jax_layer(kind)
        jp = jcls(**{f: jnp.asarray(a) for f, a in w.items()})
        jin = [jnp.asarray(a) for a in acts]
        out_c, vjp_c = jax.vjp(custom, *jin, jp)
        g_c = vjp_c(jnp.asarray(dz))
        # one grid step: the body's row offset is 0, as program_id(0) is
        with mock.patch.object(jlt.pl, "program_id", lambda axis: 0):
            out_b, vjp_b = jax.vjp(body, *jin, jp)
            g_b = vjp_b(jnp.asarray(dz))
        tp = tcls(**{f: torch.tensor(a, requires_grad=True)
                     for f, a in w.items()})
        tin = [torch.tensor(a, requires_grad=True) for a in acts]
        out_t = port_layer(kind, tin, tp)
        out_t.backward(torch.from_numpy(dz))
        g_t = [x.grad for x in tin] + [getattr(tp, f).grad
                                       for f in tcls._fields]
        flat_c = list(g_c[:-1]) + list(g_c[-1])
        flat_b = list(g_b[:-1]) + list(g_b[-1])
        print(f"  {kind:8s} JAX custom VJP vs jax.vjp of its body: output "
              f"{float(jnp.abs(out_c - out_b).max()):.2e}, grads "
              f"{max(gap(a, b) for a, b in zip(flat_c, flat_b)):.2e}; port "
              f"vs JAX custom VJP: output "
              f"{float(np.abs(out_t.detach().numpy() - out_c).max()):.2e}, "
              f"grads {max(gap(a, b) for a, b in zip(g_t, flat_c)):.2e}",
              flush=True)


def step(frames: int, rate: float) -> None:
    jcfg = Config(model=ModelConfig(dropout=rate),
                  input=InputConfig(num_frame=frames))
    tcfg = tconfig.Config(model=tconfig.ModelConfig(dropout=rate),
                          input=tconfig.InputConfig(num_frame=frames))
    rng = np.random.default_rng(0)
    shape = (1, frames, 88)
    batch = {"spec": rng.standard_normal((1, 256, jcfg.window_frames))
             .astype(np.float32),
             "onset": (rng.random(shape) > 0.95).astype(np.float32),
             "offset": (rng.random(shape) > 0.95).astype(np.float32),
             "mpe": (rng.random(shape) > 0.7).astype(np.float32),
             "velocity": rng.integers(0, 128, shape).astype(np.int32),
             "valid": np.ones(1, np.float32)}
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jcfg, jax.random.key(1), batch_size=1))
    key = jax.random.key(7)
    seeds = {i: int(jax.random.randint(jax.random.fold_in(key, 1000 + i),
                                       (), 0, 2 ** 31 - 1, dtype=jnp.int32))
             for i in tft.seed_slots(tcfg)}
    apply = jft.make_fused_apply(jcfg, interpret=True)
    g_j = jax.grad(lambda p: jstep.loss_fn(
        jcfg, apply, p, {k: jnp.asarray(v) for k, v in batch.items()},
        key)[0])(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j), tcfg)

    def port_grads(eps):
        sd = params_from_jax(params, tcfg)
        g = torch.Generator().manual_seed(5)
        sd = {k: v * (1 + eps * torch.randn(v.shape, generator=g))
              for k, v in sd.items()}
        model = HFT(tcfg, "cpu")
        model.load_state_dict(sd)
        loss, _ = tstep.loss_fn(
            tcfg, tft.make_fused_apply(tcfg), model,
            {k: torch.from_numpy(v) for k, v in batch.items()}, seeds)
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}

    got, moved = port_grads(0.0), port_grads(1e-7)
    worst = max(want, key=lambda n: gap(got[n], want[n]))
    print(f"  {frames:3d} frames, dropout {rate}: port vs JAX "
          f"{gap(got[worst], want[worst]):.2e} ({worst}); port vs port with "
          f"weights moved 1e-7 "
          f"{max(gap(moved[n], got[n]) for n in got):.2e}", flush=True)


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    layers()
    print("whole train step, batch 1 (sequences a freq layer = frames)")
    for frames in (16, 128):
        for rate in (0.0, 0.1):
            step(frames, rate)


if __name__ == "__main__":
    main()
