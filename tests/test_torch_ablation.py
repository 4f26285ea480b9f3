"""The port's per-site forward of whole models against the JAX package's
flax modules with ``attention_impl="pallas"`` (the per-site Pallas kernels
in interpret mode), on the same seeded weights (CPU, plain versions).

* ``return_attention`` (:class:`HFT`), 1FLT (``cnntime_safreq`` +
  ``linear_satime``) and 2FDT (``cnnblock_safreq`` + ``cafreq_satime``,
  random BatchNorm running statistics): every output key, the attention map
  included, in f32, and the gradients of a loss over every output (the
  map included: K11's probability cotangent) at dropout 0.
* 2FDT in train mode (BatchNorm on batch statistics, the conv-block
  dropout at 0 on both sides): outputs, gradients and the updated running
  statistics against JAX's ``mutable=["batch_stats"]`` result.
* Weights: ``params_from_jax`` carries the conv kernels and the batch
  statistics; the reference ``.dat`` round-trips with ``strict=True``.
* CLI: 1FLT and 2FDT ``train`` -> checkpoint -> ``transcribe`` on the
  CPU.

Tolerances: the port's plain versions are the JAX kernels' bodies op for
op (exp2, deferred normalisation), so the two differ by f32 reduction
order alone, amplified by the saturated frequency-encoder softmax on
unit-normal input (``tests/test_attention.py`` explains it). The readings
on these weights: outputs <= 2.9e-6 apart, gradients (scaled by max(1,
|grad|max)) <= 7.6e-5 (return_attention) and <= 1.3e-5 (2FDT, eval and
train mode); the gates sit 4-7x above them, as ``tests/test_attention.py``
derives its own. 1FLT feeds the un-normalised bin projection into stage 2
scaled by sqrt(hid): one f32 ulp of noise in ``fc_convert``'s weights alone
moves its B heads by up to 1.7e-5, and port and JAX read 3.7e-5 apart
there; its output gate is 1.5e-4. BatchNorm's running statistics read
1.2e-7 apart (gate 1e-6).
"""

import functools
import json

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from nylon_amt_tpu.config import Config as JConfig
from nylon_amt_tpu.config import InputConfig as JInputConfig
from nylon_amt_tpu.config import ModelConfig as JModelConfig
from nylon_amt_tpu.models import ablation as jab
from nylon_amt_tpu.models.hft import Decoder as JDecoder
from nylon_amt_tpu.models.hft import build_model as j_build_model
from nylon_amt_tpu.train.importer import convert_state_dict
from nylon_amt_tpu_torch import cli
from nylon_amt_tpu_torch.config import Config, InputConfig, ModelConfig
from nylon_amt_tpu_torch.models import ablation as tab
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import build_model
from nylon_amt_tpu_torch.models.init import reference_initialize
from nylon_amt_tpu_torch.train.importer import build_rules
from nylon_amt_tpu_torch.utils.wavio import save_wav

from test_torch_train import _corpus

NUM_FRAME = 32  # frames per window (128 in the paper): a quarter of the work
SMALL = dict(hid_dim=16, pf_dim=32, enc_layer=1, dec_layer=2, enc_head=2,
             dec_head=2, dropout=0.0)
# the decoder layer with self attention runs in the return_attention model;
# the ablation models keep one layer per stage (fewer sites to interpret)
MODELS = {"return_attention": dict(return_attention=True),
          "1FLT": dict(dec_alg="linear_satime", dec_layer=1),
          "2FDT": dict(enc_alg="cnnblock_safreq", dec_layer=1)}
FWD_ATOL = {"return_attention": 2e-5, "1FLT": 1.5e-4, "2FDT": 2e-5,
            "2FDT train": 3e-5}
GRAD_ATOL = {"return_attention": 3e-4, "1FLT": 1.2e-4, "2FDT": 1.2e-4,
             "2FDT train": 1.2e-4}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: these tests run many small PyTorch ops,
    and with the suite's workers sharing the cores, a pool of threads per
    worker only waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    kw = {**SMALL, **MODELS[name]}
    return (JConfig(input=JInputConfig(num_frame=NUM_FRAME),
                    model=JModelConfig(attention_impl="pallas", **kw)),
            small_config(**kw))


def small_config(**model_kw):
    """The port's config of these tests: ``NUM_FRAME`` frames a window."""
    return Config(input=InputConfig(num_frame=NUM_FRAME),
                  model=ModelConfig(**model_kw))


def _spec(seed=0, B=1):
    return np.random.default_rng(seed).standard_normal(
        (B, 256, NUM_FRAME + 64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(port ``state_dict``, the same weights as flax variables): the
    port's seeded reference init, random BatchNorm running statistics for
    2FDT, carried to flax by the JAX package's importer."""
    _, cfg = _configs(name)
    model = reference_initialize(build_model(cfg, "cpu"),
                                 torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    for key, t in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            t.copy_(0.5 + torch.rand(t.shape, generator=g))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    m = cfg.model
    out = convert_state_dict(sd, m.enc_layer, m.dec_layer, m.enc_alg,
                             m.dec_alg, with_batch_stats=True)
    return sd, ({"params": out[0], "batch_stats": out[1]} if out[1]
                else {"params": out[0]})


def _port(name):
    _, cfg = _configs(name)
    model = build_model(cfg, "cpu")
    model.load_state_dict(_weights(name)[0], strict=True)
    return cfg, model


def _loss_jax(out):
    return sum(jnp.mean(jnp.tanh(v.astype(jnp.float32)))
               for k, v in sorted(out.items()))


def _loss_port(out):
    return sum(torch.tanh(v.float()).mean() for k, v in sorted(out.items()))


def _grads_close(model, cfg, jgrads, atol, batch_stats=None):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg,
                           batch_stats)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        scale = max(1.0, want[name].abs().max().item())
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   want[name].numpy() / scale,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_per_site_forward_and_grads_match_jax(name):
    jcfg, _ = _configs(name)
    v = _weights(name)[1]
    jmodel = j_build_model(jcfg)
    spec = _spec()

    def run(p):
        out = jmodel.apply({**v, "params": p}, spec, deterministic=True)
        return _loss_jax(out), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(run, has_aux=True))(
        v["params"])
    cfg, model = _port(name)
    out = model.per_site(torch.from_numpy(spec))
    assert set(out) == set(jout)
    if name == "return_attention":
        assert out["attention"].shape == (1, NUM_FRAME, 2, 88, 256)
    for k, ref in jout.items():
        np.testing.assert_allclose(out[k].detach().float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=FWD_ATOL[name], rtol=0, err_msg=k)
    _loss_port(out).backward()
    _grads_close(model, cfg, jgrads, GRAD_ATOL[name], v.get("batch_stats"))


class _AblationNoConvDrop(fnn.Module):
    """JAX's ``AblationModel`` for 2FDT with the conv-block dropout at 0
    (its default 0.1 draws from ``jax.random``): train mode is then
    deterministic apart from BatchNorm's batch statistics."""

    config: JConfig

    @fnn.compact
    def __call__(self, spec, deterministic=True):
        cfg, m = self.config, self.config.model
        h = jab.CNNBlockEncoder(
            n_margin=cfg.input.margin_b, n_frame=cfg.input.num_frame,
            n_bin=cfg.feature.n_bins, hid_dim=m.hid_dim,
            n_layers=m.enc_layer, n_heads=m.enc_head, pf_dim=m.pf_dim,
            dropout=m.dropout, dropout_convblock=0.0, impl="pallas",
            name="encoder")(spec, deterministic)
        return JDecoder(
            n_frame=cfg.input.num_frame, n_bin=cfg.feature.n_bins,
            n_note=cfg.midi.num_note, n_velocity=cfg.midi.num_velocity,
            hid_dim=m.hid_dim, n_layers=m.dec_layer, n_heads=m.dec_head,
            pf_dim=m.pf_dim, dropout=m.dropout, impl="pallas",
            return_attention=False, name="decoder")(h, deterministic)


def test_2fdt_train_mode_batch_norm_matches_jax():
    jcfg, _ = _configs("2FDT")
    v = _weights("2FDT")[1]
    jmodel = _AblationNoConvDrop(jcfg)
    spec = _spec(seed=3)

    def run(p):
        out, upd = jmodel.apply({**v, "params": p}, spec,
                                deterministic=False, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.key(0)})
        return _loss_jax(out), (out, upd["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.jit(
        jax.value_and_grad(run, has_aux=True))(v["params"])
    cfg, model = _port("2FDT")
    model.encoder_spec2midi.dropout_convblock = 0.0
    out = model.per_site(torch.from_numpy(spec), seeds={})
    for k, ref in jout.items():
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref),
                                   atol=FWD_ATOL["2FDT train"], rtol=0,
                                   err_msg=k)
    _loss_port(out).backward()
    _grads_close(model, cfg, jgrads, GRAD_ATOL["2FDT train"],
                 v["batch_stats"])
    want = params_from_jax(v["params"], cfg,
                           jax.tree_util.tree_map(np.asarray, jstats))
    sd = model.state_dict()
    moved = 0
    for key in sd:
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), want[key].numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=key)
            moved += not torch.equal(sd[key], params_from_jax(
                v["params"], cfg, v["batch_stats"])[key])
        elif key.endswith("num_batches_tracked"):
            assert sd[key].item() == 1
    assert moved == 16


def test_conv_block_train_mode_against_float64():
    """One conv block in train mode (two convs + BatchNorm on batch
    statistics + ReLU, the pool): the port's f32 output and gradients are
    as close to a float64 twin as JAX's f32 ConvBlock is (within twice its
    distance, or f32 summation noise, 1e-5 of the largest value)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 20, 32, 16)) + 0.5).astype(np.float32)
    co = rng.standard_normal((2, 20, 16, 24)).astype(np.float32)
    block = jab.ConvBlock(24)
    v = block.init(jax.random.key(0), x)

    def run(p, x):
        out, _ = block.apply({**v, "params": p}, x, deterministic=False,
                             mutable=["batch_stats"])
        return jnp.sum(jnp.tanh(out) * co), out

    (_, jout), (jg, jgx) = jax.value_and_grad(run, (0, 1), has_aux=True)(
        v["params"], x)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))
    results = {}
    for dt in (torch.float32, torch.float64):
        seq = torch.nn.Sequential(
            torch.nn.Conv2d(16, 24, 3, padding=1), torch.nn.BatchNorm2d(24),
            torch.nn.ReLU(), torch.nn.Conv2d(24, 24, 3, padding=1),
            torch.nn.BatchNorm2d(24), torch.nn.ReLU()).to(dt)
        with torch.no_grad():
            for i, j in ((0, 0), (3, 1)):
                seq[i].weight.copy_(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(v["params"][f"conv_{j}"]["kernel"])
                    .transpose(3, 2, 0, 1))))
                seq[i].bias.copy_(torch.from_numpy(
                    np.array(v["params"][f"conv_{j}"]["bias"])))
        xt = nchw(x).to(dt).requires_grad_()
        if dt == torch.float32:
            out = tab.conv_block(xt, seq, dt, True)
        else:                        # the same formulas in float64
            h = xt
            for conv, bn in ((seq[0], seq[1]), (seq[3], seq[4])):
                h = F.conv2d(h, conv.weight, padding=1) \
                    + conv.bias[:, None, None]
                mean = h.mean((0, 2, 3))
                var = (h * h).mean((0, 2, 3)) - mean * mean
                h = torch.relu((h - mean[:, None, None])
                               * (torch.rsqrt(var + 1e-5)
                                  * bn.weight)[:, None, None]
                               + bn.bias[:, None, None])
            out = h.reshape(*h.shape[:3], -1, 2).mean(-1)
        (torch.tanh(out) * nchw(co).to(dt)).sum().backward()
        results[dt] = [t.double() for t in (
            out.detach(), seq[0].weight.grad, seq[3].weight.grad, xt.grad)]
    jax_side = [nchw(jout).double()] + [
        torch.from_numpy(np.ascontiguousarray(
            np.asarray(jg[f"conv_{j}"]["kernel"]).transpose(3, 2, 0, 1)))
        .double() for j in (0, 1)] + [nchw(jgx).double()]
    for name, port, jx, truth in zip(("out", "dw0", "dw1", "dx"),
                                     results[torch.float32], jax_side,
                                     results[torch.float64]):
        top = truth.abs().max().item()
        e_port = (port - truth).abs().max().item() / top
        e_jax = (jx - truth).abs().max().item() / top
        # f32 sums over 5k positions in another order: ~1e-6 either side
        assert e_port <= max(2.0 * e_jax, 1e-5), (name, e_port, e_jax)


def test_params_from_jax_carries_conv_and_batch_stats(tmp_path):
    """A 2FDT ``state_dict`` through the JAX package's importer and back
    through ``params_from_jax`` is the same tensors (conv kernels OIHW <->
    HWIO, running statistics <-> ``batch_stats``); the ``.dat`` loads with
    ``strict=True``."""
    sd, v = _weights("2FDT")
    _, cfg = _configs("2FDT")
    m = cfg.model
    back = params_from_jax(v["params"], cfg, v["batch_stats"])
    assert set(back) == set(sd) == set(build_rules(
        m.enc_layer, m.dec_layer, m.enc_alg, m.dec_alg))
    for key, t in sd.items():
        if key.endswith("num_batches_tracked"):
            assert back[key].item() == 0      # flax keeps no count
        else:
            assert torch.equal(back[key], t), key
    np.testing.assert_array_equal(
        v["params"]["encoder"]["conv_block_2"]["conv_1"]["kernel"],
        sd["encoder_spec2midi.conv_2.3.weight"].numpy().transpose(2, 3, 1, 0))
    torch.save({"model_dict": sd}, tmp_path / "model.dat")
    loaded = cli.load_model(str(tmp_path / "model.dat"), cfg, "cpu")
    for key, t in sd.items():
        assert torch.equal(loaded.state_dict()[key], t), key
    with pytest.raises(KeyError, match="batch_stats"):
        params_from_jax(v["params"], cfg, {**v["batch_stats"], "x": 1.0})


@pytest.mark.parametrize("name", ["1FLT", "2FDT"])
def test_cli_train_checkpoint_transcribe(tmp_path, name):
    """The ablation model through ``cli train`` (two steps; 2FDT's
    BatchNorm statistics move and travel in the ``.dat``), then ``cli
    transcribe`` with its checkpoint (both head families)."""
    cfg = small_config(**{**SMALL, **MODELS[name], "dropout": 0.1})
    sd = train_and_transcribe(tmp_path, cfg)
    if name == "2FDT":
        bn = "encoder_spec2midi.conv_1.1."
        assert sd[bn + "num_batches_tracked"].item() == 2
        assert not torch.equal(sd[bn + "running_var"],
                               torch.ones_like(sd[bn + "running_var"]))


def train_and_transcribe(tmp_path, cfg, *extra):
    """``cli train`` for one epoch (two steps of two windows) on the seeded
    corpus of ``tests/test_torch_train.py``, then ``cli transcribe`` of a
    3 s WAV with the checkpoint; returns the checkpoint's state_dict."""
    cfg_path = tmp_path / "config.json"
    cfg.save(str(cfg_path))
    corpus = _corpus(tmp_path, cfg)
    assert cli.main(["train", "--config", str(cfg_path), "--dataset",
                     str(corpus), "--out", str(tmp_path / "run"),
                     "--n-slice", "16", "--epochs", "1", "--batch-size", "2",
                     "--device", "cpu", *extra]) == 0
    perf = json.loads((tmp_path / "run" / "performance.json").read_text())
    assert np.isfinite(perf["loss_train"][0])
    assert np.isfinite(perf["loss_valid"][0])
    manifest = json.loads((tmp_path / "run" / "parameter.json").read_text())
    assert manifest["config"]["model"]["remat"] == ("--remat" in extra)
    ckpt = tmp_path / "run" / "checkpoints" / "model_000_000" / "model.dat"
    t = np.arange(3 * 16000) / 16000
    save_wav(str(tmp_path / "piece.wav"),
             0.3 * np.sin(2 * np.pi * 440 * t), 16000)
    assert cli.main(["transcribe", "--checkpoint", str(ckpt), "--config",
                     str(cfg_path), "--wav", str(tmp_path / "piece.wav"),
                     "--out", str(tmp_path / "midi"), "--batch-windows",
                     "2", "--device", "cpu"]) == 0
    assert (tmp_path / "midi" / "piece.mid").exists()
    if cfg.model.dec_alg != "cafreq":
        assert (tmp_path / "midi" / "piece_2nd.notes.json").exists()
    return torch.load(ckpt, weights_only=True)["model_dict"]
