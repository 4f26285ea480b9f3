"""The port's per-site attention (K10 ``fused_mha``, K11
``fused_mha_with_probs``, K12 ``fused_mha_dropout``) against the JAX
package's Pallas kernels run in interpret mode, on the same seeded inputs.

* f32: forward and the gradients of a loss through every output (K11's
  probabilities included, so its plain probs-cotangent term is held too)
  at 2e-5; K12 at rate 0.1 with JAX's seed to 1e-6, its masks bit-identical
  to JAX's. ``Lk = 256`` takes the packed 16-bit masks, ``Lk = 88`` the
  unpacked ones.
* bf16: the port within 4 bf16 ulps (of the output's largest value) of
  JAX's bf16 kernels, and both within the scale-invariant gate of the f32
  truth, with JAX run in a fresh interpreter without XLA's excess
  precision (see ``tests/test_torch_layer_fused_train.py``).
* ``remat`` changes neither the loss nor the gradients (dropout on, the
  same seeds), and ``cli train --remat`` -> ``cli transcribe`` runs; the
  routing of the train step, eval step and transcriber by configuration;
  no kernel counter moves on the CPU.
"""

import functools
import json
import math
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
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.infer.transcribe import Transcriber
from nylon_amt_tpu_torch.models import fused_train
from nylon_amt_tpu_torch.models.hft import (
    Model, build_model, draw_site_seeds)
from nylon_amt_tpu_torch.models.init import reference_initialize
from nylon_amt_tpu_torch.ops import attention as tatt
from nylon_amt_tpu_torch.train import step as tstep

from test_torch_ablation import (  # noqa: F401 (one_thread: autouse)
    NUM_FRAME, SMALL, one_thread, small_config, train_and_transcribe)

N, LQ, HEADS, D = 2, 88, 2, 16
HID = HEADS * D
SCALE = 1.0 / math.sqrt(D)
RATE, SEED = 0.1, 1_234_567
HERE = Path(__file__).resolve().parent
KINDS = ("fused_mha", "fused_mha_with_probs", "fused_mha_dropout")


def _bf16_values(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _run(kind, lk, dtype, seed=0, with_jax=True, d=D):
    """(JAX, port) ``(outputs, (dq, dk, dv))`` as f32 numpy for the loss
    sum(out * co) [+ sum(probs * cp)] at head_dim ``d``; JAX's None without
    ``with_jax``."""
    rng = np.random.default_rng(seed)
    hid, scale = HEADS * d, 1.0 / math.sqrt(d)
    qkv = [_bf16_values(rng.standard_normal((N, L, hid)))
           for L in (LQ, lk, lk)]
    co = rng.standard_normal((N, LQ, hid)).astype(np.float32)
    cp = rng.standard_normal((N, HEADS, LQ, lk)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    if kind == "fused_mha":
        jfn = lambda q, k, v: (jatt.fused_mha(q, k, v, HEADS, scale, True),)
        tfn = lambda q, k, v: (tatt.fused_mha(q, k, v, HEADS, scale),)
    elif kind == "fused_mha_with_probs":
        jfn = lambda q, k, v: jatt.fused_mha_with_probs(q, k, v, HEADS,
                                                        scale, True)
        tfn = lambda q, k, v: tatt.fused_mha_with_probs(q, k, v, HEADS,
                                                        scale)
    else:
        jfn = lambda q, k, v: (jatt.fused_mha_dropout(
            q, k, v, HEADS, scale, RATE, True, jnp.int32(SEED)),)
        tfn = lambda q, k, v: (tatt.fused_mha_dropout(q, k, v, HEADS, scale,
                                                      RATE, SEED),)
    cots = (co, cp)

    @jax.jit
    def jax_side(q, k, v):
        out, vjp = jax.vjp(jfn, q, k, v)
        return out, vjp(tuple(jnp.asarray(c).astype(o.dtype)
                              for c, o in zip(cots, out)))

    tin = [torch.from_numpy(a).to(tdt).requires_grad_() for a in qkv]
    tout = tfn(*tin)
    torch.autograd.backward(tout, [torch.from_numpy(c).to(o.dtype)
                                   for c, o in zip(cots, tout)])
    port = ([o.detach().float().numpy() for o in tout],
            [t.grad.float().numpy() for t in tin])
    if not with_jax:
        return None, port
    jout, jgrads = jax_side(*(jnp.asarray(a).astype(jdt) for a in qkv))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return ([f32(o) for o in jout], [f32(g) for g in jgrads]), port


@pytest.mark.parametrize("lk", [256, 88])
@pytest.mark.parametrize("kind", KINDS)
def test_matches_jax_f32(kind, lk):
    (jo, jg), (to, tg) = _run(kind, lk, "f32")
    atol = 1e-6 if kind == "fused_mha_dropout" else 2e-5
    for i, (a, b) in enumerate(zip(to, jo)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, err_msg=f"output {i}")
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("lk", [256, 88])
@pytest.mark.parametrize("kind", ["fused_mha", "fused_mha_dropout"])
def test_head_dim_32_matches_jax_f32(kind, lk):
    """The head width of the default ``ModelConfig()`` (hid 64 over 2
    heads): the plain ``mha_plain`` / ``mha_bwd_plain``, dropout off and
    on, against JAX's kernels in interpret mode, at the tolerances of
    :func:`test_matches_jax_f32`."""
    (jo, jg), (to, tg) = _run(kind, lk, "f32", d=32)
    atol = 1e-6 if kind == "fused_mha_dropout" else 2e-5
    assert to[0].shape == (N, LQ, HEADS * 32)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, atol=atol)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_kernel_geometry_checks_by_head_dim(d):
    """The kernels (engine layers, training layers, per-site attention, and
    the int8 layers with their own attention) take head_dim 32 and 64, in
    bf16 and f32. Each check raises on what it does not take, on the CPU,
    before any launch."""
    from nylon_amt_tpu_torch.ops import layer_fused as tlf
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as tlq

    heads = 2
    hid = heads * d
    bf16_ok = int8_ok = d in (32, 64)
    checks = {
        "layer": lambda: tlf.check_geometry("layer", hid, heads, 88, 256,
                                            2 * hid),
        "attention": lambda: tlf.check_geometry("attention", hid, heads,
                                                256, 256),
        "int8 layer": lambda: tlq.check_geometry("q8", hid, heads, 128, 256),
    }
    for name, check in checks.items():
        ok = int8_ok if name == "int8 layer" else bf16_ok
        if ok:
            check()
        else:
            with pytest.raises(ValueError, match="head_dim"):
                check()
    # more than 256 queries or keys, or an FFN off the 32-column grid
    with pytest.raises(ValueError):
        tlf.check_geometry("attention", 128, 2, 257, 256)
    with pytest.raises(ValueError):
        tlf.check_geometry("layer", 128, 2, 256, 256, 80)


@pytest.mark.parametrize("lk", [256, 88])
def test_k12_masks_are_jax_masks(lk):
    """Head h's mask is JAX's ``hash_keep_mask(seed, h, ...)`` on the
    ``(N, Lq, Lk)`` probabilities, bit for bit; the mask the plain K12 uses
    is read back from its output with one-hot values (v = I)."""
    shape = (N, LQ, lk)
    for h in range(HEADS):
        want = np.array(jatt.hash_keep_mask(jnp.int32(SEED), h, 0, shape,
                                            RATE))
        got = tatt.hash_keep_mask_plain(SEED, h, 0, shape, RATE)
        assert torch.equal(got, torch.from_numpy(want)), h
    # with v the identity over keys and q = 0 (uniform p), each output row
    # is keep / lk: the realized mask of head 0
    q = torch.zeros(N, LQ, 2 * lk)
    v = torch.zeros(N, lk, 2 * lk)
    v[:, :, :lk] = torch.eye(lk)
    out = tatt.fused_mha_dropout(q, v.clone(), v, 2, SCALE, RATE, SEED)
    realized = out[..., :lk] * lk
    want = tatt.hash_keep_mask_plain(SEED, 0, 0, shape, RATE)
    torch.testing.assert_close(realized, want, rtol=1e-6, atol=1e-6)


def _bf16_gate_rows():
    """``[(kind, lk, name, ulps from JAX bf16, port err, JAX err)]``: the
    port's bf16 outputs and gradients against JAX's bf16 ones (in bf16 ulps
    of max |JAX|) and both against the f32 truth (relative to max(|truth|,
    1)): the port's f32 plain version, which :func:`test_matches_jax_f32`
    holds to JAX's f32 within 2e-5."""
    rows = []
    for kind in KINDS:
        for lk in (256, 88):
            truth = _run(kind, lk, "f32", with_jax=False)[1]
            j16, t16 = _run(kind, lk, "bf16")
            names = [f"out{i}" for i in range(len(truth[0]))] + \
                ["dq", "dk", "dv"]
            for name, ref, a, b in zip(names, truth[0] + truth[1],
                                       t16[0] + t16[1], j16[0] + j16[1]):
                top = float(np.max(np.abs(b)))
                ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
                err = lambda x: float(np.max(np.abs(x - ref)
                                             / np.maximum(np.abs(ref), 1.0)))
                rows.append((kind, lk, name,
                             float(np.max(np.abs(a - b))) / ulp, err(a),
                             err(b)))
    return rows


@functools.lru_cache(maxsize=1)
def _bf16_rows_fresh():
    """:func:`_bf16_gate_rows` from an interpreter with XLA's excess
    precision off, where JAX rounds where its code casts."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(HERE)!r})\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "import test_torch_attention as t\n"
            "print(json.dumps(t._bf16_gate_rows()))\n")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_within_4_ulps_of_jax(kind):
    rows = [r for r in _bf16_rows_fresh() if r[0] == kind]
    assert len(rows) >= 8
    for _, lk, name, ulps, e_port, e_jax in rows:
        assert ulps <= 4.0, (kind, lk, name, ulps)
        assert e_port <= 2.0 * e_jax + 1e-3, (kind, lk, name, e_port, e_jax)


def test_probs_cotangent_costs_nothing_when_unused():
    """An unused probability map leaves K11's gradients those of K10."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((N, L, HID))
                                .astype(np.float32)).requires_grad_()
               for L in (LQ, 256, 256))
    out, _ = tatt.fused_mha_with_probs(q, k, v, HEADS, SCALE)
    g1 = torch.autograd.grad(out.square().sum(), (q, k, v))
    out = tatt.fused_mha(q, k, v, HEADS, SCALE)
    g2 = torch.autograd.grad(out.square().sum(), (q, k, v))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    _, probs = tatt.fused_mha_with_probs(q, k, v, HEADS, SCALE)
    dq, dk, dv = torch.autograd.grad(probs.square().sum(), (q, k, v),
                                     allow_unused=True)
    assert dv is not None and not dv.any()
    assert dq.abs().max() > 0 and dk.abs().max() > 0


# ----------------------------------------------------------- model level --

def _small(**kw):
    return small_config(**{**SMALL, "dropout": 0.1, **kw})


def _batch(B=1, seed=0):
    rng = np.random.default_rng(seed)
    frames = (B, NUM_FRAME, 88)
    return {
        "spec": torch.from_numpy(rng.standard_normal(
            (B, 256, NUM_FRAME + 64)).astype(np.float32)),
        "onset": torch.from_numpy((rng.random(frames) > 0.95)
                                  .astype(np.float32)),
        "offset": torch.from_numpy((rng.random(frames) > 0.95)
                                   .astype(np.float32)),
        "mpe": torch.from_numpy((rng.random(frames) > 0.7)
                                .astype(np.float32)),
        "velocity": torch.from_numpy(rng.integers(0, 128, frames)
                                     .astype(np.int32)),
    }


def test_remat_changes_neither_loss_nor_grads():
    """The seeds are drawn before the checkpointed encoder and decoder, so
    the recompute regenerates every mask."""
    batch = _batch()
    seeds = draw_site_seeds(_small(), torch.Generator().manual_seed(4))
    results = []
    for remat in (False, True):
        cfg = _small(remat=remat)
        model = reference_initialize(build_model(cfg, "cpu"),
                                     torch.Generator().manual_seed(0))
        loss, _ = tstep.loss_fn(cfg, Model.per_site, model, batch,
                                seeds)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


ROUTES = {  # config -> (training forward, eval/transcription path)
    "main": (dict(), "fused", "engine"),
    "remat": (dict(remat=True), "per_site", "engine"),
    "return_attention": (dict(return_attention=True), "per_site",
                         "per_site"),
    "1FLT": (dict(dec_alg="linear_satime"), "per_site", "per_site"),
    "2FDT": (dict(enc_alg="cnnblock_safreq"), "per_site", "per_site"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routing_by_configuration(name):
    """The train step takes the fused layers exactly where
    ``fused_train.supports`` holds and the per-site forward elsewhere; eval
    and transcription take the engine exactly where ``engine.supports``
    holds; the per-site seeds cover every site; on the CPU no kernel
    counter moves."""
    kw, train_path, infer_path = ROUTES[name]
    cfg = _small(**kw)
    apply, draw = tstep.make_apply(cfg)
    assert fused_train.supports(cfg) == (train_path == "fused")
    assert engine.supports(cfg) == (infer_path == "engine")
    assert (apply is Model.per_site) == (train_path == "per_site")
    seeds = draw(cfg, torch.Generator().manual_seed(0))
    if train_path == "per_site":
        assert set(seeds) == set(draw_site_seeds(cfg, torch.Generator()))
    model = reference_initialize(build_model(cfg, "cpu"),
                                 torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model.per_site(_batch()["spec"])
        assert ("attention" in out) == ("return_attention" in kw)
        if infer_path == "engine":     # HFT.forward, the engine's twin
            assert "attention" not in model(_batch()["spec"])
    tr = Transcriber(cfg, model, "cpu", batch_windows=1)
    assert (tr.packed is None) == (infer_path == "per_site")
    if infer_path == "per_site":
        with pytest.raises(ValueError, match="int8"):
            Transcriber(cfg, model, "cpu", precision="int8")
    before = dict(kernels.launches)
    state = tstep.TrainState(model, tstep.make_optimizer(
        cfg, model.parameters()))
    tstep.train_step(cfg, state, _batch(), seeds, apply)
    tstep.eval_step(cfg, state, _batch())
    assert kernels.launches == before


def test_cli_train_remat_and_transcribe(tmp_path):
    """``cli train --remat`` (dropout 0.1) for one epoch, then ``cli
    transcribe`` with its checkpoint, on the CPU."""
    train_and_transcribe(tmp_path, _small(), "--remat")
