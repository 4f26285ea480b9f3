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
from nylon_amt_tpu_torch.models.hft import HFT, stem_effective_kernel, supports
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
    cfg = small_config(tab_head=True)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    _shapes(cfg))
    assert "fc_string_time" in params["decoder"]
    with pytest.raises(KeyError, match="fc_string_time"):
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
    cfg = small_config(**model_kw)
    assert not supports(cfg)
    assert not tengine.supports(cfg)
    with pytest.raises(ValueError):
        HFT(cfg, "cpu")


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
