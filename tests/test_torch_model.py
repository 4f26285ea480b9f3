"""The port's hFT module, weight conversion, initialisation and engine
against the JAX package on identical weights (CPU, plain versions)."""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nylon_amt_tpu.config import Config, ModelConfig
from nylon_amt_tpu.infer import engine as jengine
from nylon_amt_tpu.models.hft import build_model, init_params
from nylon_amt_tpu.models.hft import stem_effective_kernel as j_stem
from nylon_amt_tpu.models.init import reference_initialize as \
    reference_initialize_jax
from nylon_amt_tpu.models.init import torch_fans
from nylon_amt_tpu.train.importer import build_rules
from nylon_amt_tpu_torch.infer import engine as tengine
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models import fused_train
from nylon_amt_tpu_torch.models.hft import HFT, ported, stem_effective_kernel
from nylon_amt_tpu_torch.models.hft import build_model as t_build_model
from nylon_amt_tpu_torch.models.init import reference_initialize


def small_config(**model_kw):
    kw = dict(hid_dim=16, pf_dim=32, enc_layer=2, dec_layer=2,
              enc_head=2, dec_head=2, dropout=0.0)
    kw.update(model_kw)
    return Config(model=ModelConfig(**kw))


def _init_cfg(cfg):
    """Parameters are f32 whatever the compute dtype: one init per
    architecture."""
    return Config(model=dataclasses.replace(cfg.model,
                                            compute_dtype="float32"))


def jit_init_params(cfg, seed):
    """``init_params(cfg, jax.random.key(seed))``: the same values, with the
    flax init jitted (eager init compiles op by op and takes several times
    longer)."""
    key = jax.random.key(seed)
    raw = jax.jit(lambda k: init_params(cfg, k, reference_init=False))(key)
    return reference_initialize_jax(raw, key)


@functools.lru_cache(maxsize=None)
def _params(cfg):
    return jit_init_params(_init_cfg(cfg), 1)


def _shapes(cfg):
    """The flax parameter tree's shapes, without computing any values."""
    return jax.eval_shape(
        lambda: init_params(cfg, jax.random.key(0), reference_init=False))


def _spec(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (B, cfg.feature.n_bins, cfg.window_frames)).astype(np.float32)


def _f32(d):
    return {k: v.float().numpy() if torch.is_tensor(v)
            else np.asarray(v, np.float32)
            for k, v in d.items() if k != "attention"}


@functools.lru_cache(maxsize=None)
def _jax_module(cfg):
    model = build_model(cfg)
    apply = jax.jit(lambda p, s: model.apply({"params": p}, s,
                                             deterministic=True))
    return _f32(apply(_params(cfg), jnp.asarray(_spec(cfg))))


@functools.lru_cache(maxsize=None)
def _jax_engine(cfg):
    return _f32(jengine.forward(_params(cfg), jnp.asarray(_spec(cfg)), cfg,
                                interpret=True))


@functools.lru_cache(maxsize=None)
def _port(cfg):
    """(HFT.forward, engine.forward) of the port on the JAX weights."""
    model = HFT(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, _params(cfg)), cfg), strict=True)
    spec = torch.from_numpy(_spec(cfg))
    with torch.no_grad():
        t_mod = model.eval()(spec)
    t_eng = tengine.forward(tengine.pack_params(model, model.dtype), spec,
                            cfg)
    return _f32(t_mod), _f32(t_eng)


def test_params_from_jax_keys_and_strict_load():
    cfg = small_config()
    params = _params(cfg)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    rules = build_rules(cfg.model.enc_layer, cfg.model.dec_layer)
    assert set(sd) == set(rules)
    model = HFT(cfg, "cpu")
    assert set(model.state_dict()) == set(rules)
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.encoder_spec2midi.conv.weight.detach().numpy()[:, 0, 0],
        np.asarray(params["encoder"]["conv_kernel"]))
    np.testing.assert_array_equal(
        model.decoder_spec2midi.fc_velocity_time.weight.detach().numpy(),
        np.asarray(params["decoder"]["fc_velocity_time"]["kernel"]).T)


def test_params_from_jax_rejects_uncovered_leaves():
    """A tree with a leaf the config's rules do not cover (a tab-head tree
    carried with a config without the head) raises; with the head in the
    config, the same tree is carried."""
    cfg = small_config(tab_head=True)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    _shapes(cfg))
    assert "fc_string_time" in params["decoder"]
    with pytest.raises(KeyError, match="fc_string_time"):
        params_from_jax(params, small_config())
    assert "decoder_spec2midi.fc_string_time.weight" in \
        params_from_jax(params, cfg)


@pytest.mark.parametrize("dec_alg", ["cafreq_satime", "cafreq"])
def test_forward_matches_jax_f32(dec_alg):
    cfg = small_config(dec_alg=dec_alg)
    j_mod, j_eng = _jax_module(cfg), _jax_engine(cfg)
    t_mod, t_eng = _port(cfg)
    keys = {"onset_A", "offset_A", "mpe_A", "velocity_A"}
    if dec_alg == "cafreq_satime":
        keys |= {k.replace("_A", "_B") for k in keys}
    for out in (j_eng, t_mod, t_eng):
        assert set(out) == keys
    for k in sorted(keys):
        for name, ref in (("module", j_mod), ("engine", j_eng)):
            for port_name, got in (("HFT.forward", t_mod),
                                   ("engine.forward", t_eng)):
                assert got[k].shape == ref[k].shape
                np.testing.assert_allclose(
                    got[k], ref[k], atol=2e-4, rtol=2e-4,
                    err_msg=f"{k}: port {port_name} vs JAX {name}")


def test_forward_bf16_gate():
    """Port bf16 (module and engine) against the JAX f32 truth, within twice
    the JAX bf16 module's own error + 1e-3 (tests/test_engine.py's gate)."""
    cfg16 = small_config(compute_dtype="bfloat16")
    j16, (t16, te16) = _jax_module(cfg16), _port(cfg16)
    truth = _jax_module(small_config())          # same init
    for k, t in truth.items():
        scale = np.maximum(np.abs(t), 1.0)
        e_jax = np.max(np.abs(j16[k] - t) / scale)
        for name, got in (("HFT.forward", t16), ("engine.forward", te16)):
            e_port = np.max(np.abs(got[k] - t) / scale)
            assert e_port <= 2.0 * e_jax + 1e-3, (k, name, e_port, e_jax)


def test_engine_stage2_is_the_module_stage2_on_the_same_tokens():
    """``engine.stage2`` fed a stage-1 token tensor gives the module's stage
    2 (``models.hft.stage2``, the time layers and the B heads) on the same
    tokens, in f32 within 1e-5; and ``engine.forward``'s B heads are its
    stage 2 on the engine's own stage-1 tokens."""
    from nylon_amt_tpu_torch.models.hft import PLAIN, stage2

    cfg = small_config()
    model = reference_initialize(HFT(cfg, "cpu"),
                                 torch.Generator().manual_seed(3)).eval()
    packed = tengine.pack_params(model, model.dtype)
    B, n_frame = 2, cfg.input.num_frame
    trg = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B * n_frame, cfg.midi.num_note, cfg.model.hid_dim))
        .astype(np.float32))
    got = tengine.stage2(packed, trg, B, cfg)
    with torch.no_grad():
        want = stage2(model.decoder_spec2midi, trg, B, n_frame, model.dtype,
                      PLAIN, {})
    assert set(got) == set(want) == {"onset_B", "offset_B", "mpe_B",
                                     "velocity_B"}
    for k, w in want.items():
        g = got[k] if k.startswith("velocity") else got[k][..., 0]
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    # forward's B heads: stage2 on the tokens its stage 1 handed on
    seen = {}
    real = tengine.stage2

    def record(packed_, trg_, B_, cfg_):
        seen["out"] = real(packed_, trg_, B_, cfg_)
        return seen["out"]

    tengine.stage2 = record
    try:
        out = tengine.forward(packed, torch.from_numpy(_spec(cfg)), cfg)
    finally:
        tengine.stage2 = real
    for k, v in seen["out"].items():
        assert torch.equal(out[k], v if k.startswith("velocity")
                           else v[..., 0])


def test_stem_effective_kernel_matches_jax():
    rng = np.random.default_rng(5)
    cc, ck, hid, margin = 4, 5, 16, 32
    conv_out = 2 * margin + 1 - (ck - 1)
    args = [rng.standard_normal(s).astype(np.float32) for s in
            ((cc, ck), (cc,), (cc * conv_out, hid), (hid,))]
    kw = dict(cnn_channel=cc, cnn_kernel=ck, hid_dim=hid, n_margin=margin)
    jk, jb = j_stem(*(jnp.asarray(a) for a in args), **kw)
    tk, tb = stem_effective_kernel(*(torch.from_numpy(a) for a in args), **kw)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("model_kw", [
    dict(tab_head=True), dict(enc_alg="cnnblock_safreq"),
    dict(dec_alg="linear_satime"), dict(return_attention=True)])
def test_supports_rejects_what_is_not_ported(model_kw):
    """The ablation models and the attention map are ported:
    ``build_model`` builds them, while the engine and the fused training
    layers leave them to the per-site path, as the JAX package's
    ``supports`` do. The tab head is ported on every path: the engine and
    the fused training layers take it, and ``build_model`` builds
    :class:`HFT` with it."""
    cfg = small_config(**model_kw)
    if model_kw.get("tab_head"):
        assert ported(cfg)
        assert tengine.supports(cfg) and fused_train.supports(cfg)
        assert isinstance(t_build_model(cfg, "cpu"), HFT)
        return
    assert not tengine.supports(cfg)
    assert not fused_train.supports(cfg)
    assert ported(cfg)
    model = t_build_model(cfg, "cpu")
    assert isinstance(model, HFT) == ("return_attention" in model_kw)


def test_reference_initialize_follows_the_reference_recipe():
    """xavier-uniform weights and U(+-1/sqrt(fan_in)) biases with the
    reference's torch fans (as the JAX package computes them), ones/zeros
    for LayerNorm; deterministic in the generator's seed."""
    cfg = small_config(hid_dim=32, pf_dim=64)
    m = cfg.model

    def init(seed):
        return reference_initialize(
            HFT(cfg, "cpu"), torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = init(0), init(0), init(1)
    rules = build_rules(m.enc_layer, m.dec_layer)
    flax_shapes = jax.tree_util.tree_map(
        np.shape, _shapes(cfg))
    for key, (path, _) in rules.items():
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
        w = a[key].abs().max().item()
        if key.endswith("layer_norm.weight"):
            assert torch.all(a[key] == 1)
            continue
        if key.endswith("layer_norm.bias"):
            assert torch.all(a[key] == 0)
            continue
        assert not torch.equal(a[key], c[key]), key
        node = flax_shapes
        for p in path:
            node = node[p]
        fans = torch_fans(path, node)
        if fans is not None:
            bound = math.sqrt(6.0 / (fans[0] + fans[1]))
        else:   # a bias: 1/sqrt(fan_in) of its layer's weight
            kpath = path[:-1] + (path[-1][: -len("bias")] + "kernel",)
            node = flax_shapes
            for p in kpath:
                node = node[p]
            bound = 1.0 / math.sqrt(torch_fans(kpath, node)[0])
        assert w <= bound, (key, w, bound)
        if a[key].numel() >= 256:
            assert w >= 0.9 * bound, (key, w, bound)


def test_hft_parameters_live_on_the_given_device():
    model = HFT(small_config(), "cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert model.dtype == torch.float32
    assert HFT(small_config(compute_dtype="bfloat16"), "cpu").dtype == \
        torch.bfloat16


# ------------------------------------ the default configuration: head_dim 32 --

def test_default_config_forward_matches_jax():
    """The default ``ModelConfig()`` (hid 64 over 2 heads, so head_dim 32:
    the width the CUDA kernels take beside 64): JAX's module against the
    port's ``HFT.forward`` and ``engine.forward`` (plain versions) on the
    same weights, f32, at :func:`test_forward_matches_jax_f32`'s 2e-4."""
    cfg = Config()
    assert cfg.model.hid_dim // cfg.model.enc_head == 32
    j_mod = _jax_module(cfg)
    t_mod, t_eng = _port(cfg)
    assert set(t_mod) == set(t_eng) == set(j_mod)
    for k in sorted(j_mod):
        for name, got in (("HFT.forward", t_mod), ("engine.forward", t_eng)):
            assert got[k].shape == j_mod[k].shape
            np.testing.assert_allclose(got[k], j_mod[k], atol=2e-4,
                                       rtol=2e-4, err_msg=f"{k}: {name}")


@pytest.mark.parametrize("dropout,frames", [(0.0, 128), (0.1, 16)])
def test_default_config_train_step_matches_jax(dropout, frames):
    """One training step of the default ``ModelConfig()``: the port's loss
    over its fused training forward (the plain twins of K7-K9, head_dim
    32) against JAX's over ``make_fused_apply(cfg, interpret=True)``, as
    ``tests/test_torch_train.py`` holds the small model: loss at rtol 1e-5,
    every gradient at 5e-4 of its largest |grad|; with dropout, both run
    JAX's per-layer seeds. Dropout 0.1 runs on windows of 16 frames (16
    sequences a frequency layer): at 128 frames the f32 gradient of the
    stem moves by more than 5e-4 when every weight moves by 1e-7 of its
    value (ReLU gates and LN rows that flip with rounding), in the port
    alone as between port and JAX (``scripts/probe_default_width_grads.py``
    prints both, and shows each training layer of both packages equal to
    JAX's gradient of its own forward at 128 sequences)."""
    from nylon_amt_tpu.config import InputConfig
    from nylon_amt_tpu.models import fused_train as jft
    from nylon_amt_tpu.train import step as jstep
    from nylon_amt_tpu_torch import config as tconfig
    from nylon_amt_tpu_torch.train import step as tstep

    jcfg = Config(model=ModelConfig(dropout=dropout),
                  input=InputConfig(num_frame=frames))
    tcfg = tconfig.Config(model=tconfig.ModelConfig(dropout=dropout),
                          input=tconfig.InputConfig(num_frame=frames))
    assert tcfg.to_dict() == jcfg.to_dict()
    assert dataclasses.replace(tconfig.ModelConfig(), dropout=dropout) == \
        tcfg.model
    rng = np.random.default_rng(0)
    shape = (1, frames, 88)
    batch = {"spec": rng.standard_normal((1, 256, jcfg.window_frames))
             .astype(np.float32),
             "onset": (rng.random(shape) > 0.95).astype(np.float32),
             "offset": (rng.random(shape) > 0.95).astype(np.float32),
             "mpe": (rng.random(shape) > 0.7).astype(np.float32),
             "velocity": rng.integers(0, 128, shape).astype(np.int32),
             "valid": np.ones(1, np.float32)}
    params = init_params(jcfg, jax.random.key(1), batch_size=1)
    key = jax.random.key(7)
    apply = jft.make_fused_apply(jcfg, interpret=True)
    (l_j, _), g_j = jax.value_and_grad(
        lambda p: jstep.loss_fn(jcfg, apply, p,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                key), has_aux=True)(params)
    model = HFT(tcfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    assert fused_train.supports(tcfg)
    seeds = {i: int(jax.random.randint(jax.random.fold_in(key, 1000 + i),
                                       (), 0, 2 ** 31 - 1, dtype=jnp.int32))
             for i in fused_train.seed_slots(tcfg)}
    l_t, _ = tstep.loss_fn(tcfg, fused_train.make_fused_apply(tcfg), model,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           seeds)
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j), tcfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        scale = max(1.0, want[name].abs().max().item())
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   want[name].numpy() / scale, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["enc", "dec_zero", "dec"])
def test_default_width_layer_backward_is_the_forward_gradient(kind):
    """At the default width (hid 64 over 2 heads of 32, pf 128), dropout
    0.1 and the 128 sequences a layer sees per window, each training
    layer's analytic backward twin (the function the CUDA backward is held
    to on the card) equals autograd through its forward twin: input and
    weight gradients within 2e-5 of max(1, |grad|) (two f32 orders of the
    same sums)."""
    from nylon_amt_tpu_torch.ops import layer_fused as tlf
    from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

    m = ModelConfig()
    hid, pf, heads, n, seed, rate = m.hid_dim, m.pf_dim, m.enc_head, 128, \
        1_234_567, 0.1
    rng = np.random.default_rng(2)
    cls = {"enc": tlf.EncoderLayerParams, "dec_zero": tlt.DecZeroParams,
           "dec": tlt.DecLayerParams}[kind]
    shapes = tlf.weight_shapes(hid, pf)

    def weight(f):
        if f == "g":
            return 1.0 + 0.1 * rng.standard_normal(hid)
        if f == "b" or f.startswith("b"):
            return 0.1 * rng.standard_normal(shapes[f])
        return rng.standard_normal(shapes[f]) / math.sqrt(shapes[f][0])

    w = {f: torch.tensor(weight(f), dtype=torch.float32)
         for f in cls._fields}
    lq = 256 if kind == "enc" else 88
    acts = [torch.from_numpy(rng.standard_normal((n, lq, hid))
                             .astype(np.float32))]
    if kind != "enc":
        acts.append(torch.from_numpy(rng.standard_normal((n, 256, hid))
                                     .astype(np.float32)))
    dz = torch.from_numpy(rng.standard_normal((n, lq, hid))
                          .astype(np.float32))
    ins = [a.clone().requires_grad_() for a in acts]
    p = cls(**{f: t.clone().requires_grad_() for f, t in w.items()})
    if kind == "enc":
        z = tlt.encoder_layer_train_plain(ins[0], p, seed, heads, rate)
        dx, grads = tlt.encoder_layer_train_bwd_plain(
            acts[0], cls(**w), seed, dz, heads, rate)
        analytic = [dx]
    elif kind == "dec_zero":
        z = tlt.decoder_layer_zero_train_plain(*ins, p, seed, heads, rate)
        *analytic, grads = tlt.decoder_layer_zero_train_bwd_plain(
            *acts, cls(**w), seed, dz, heads, rate)
    else:
        z = tlt.decoder_layer_train_plain(*ins, p, seed, heads, rate)
        *analytic, grads = tlt.decoder_layer_train_bwd_plain(
            *acts, cls(**w), seed, dz, heads, rate)
    z.backward(dz)
    pairs = [(f"d{i}", a, t.grad) for i, (a, t) in enumerate(zip(analytic,
                                                                  ins))]
    pairs += [(f, getattr(grads, f), getattr(p, f).grad) for f in cls._fields]
    for name, a, auto in pairs:
        scale = max(1.0, auto.abs().max().item())
        np.testing.assert_allclose(a.detach().numpy() / scale,
                                   auto.numpy() / scale, atol=2e-5,
                                   err_msg=name)
