"""The port's training slice against the JAX package, on the CPU.

* The port's own copies of framework-neutral modules (config, MIDI writer,
  native decoder, reference key table) behave exactly as their originals.
* Full model: the port's ``loss_fn`` over ``train_forward`` (plain twins,
  dropout 0.1, JAX's per-layer seeds passed in) against JAX ``loss_fn``
  over ``make_fused_apply(cfg, interpret=True)``: loss at rtol 1e-5, every
  parameter gradient at 5e-4 after scaling by its largest |grad|.
* Trajectory: 3 Adam steps (lr 1e-3, dropout 0) of the port's train step
  against JAX ``make_train_step`` (its flax path on the CPU) on identical
  weights and batches: parameters within 1e-4 of their largest |value|.
* Trainer: ``cli train --device cpu`` on a seeded synthetic corpus, resume,
  and the written ``.dat`` through ``cli transcribe``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nylon_amt_tpu import config as jconfig
from nylon_amt_tpu.data.windows import WindowDataset as JWindowDataset
from nylon_amt_tpu.infer.decode import mpe2note as j_mpe2note
from nylon_amt_tpu.midi.smf import write_notes as j_write_notes
from nylon_amt_tpu.models import fused_train as jft
from nylon_amt_tpu.models.hft import init_params
from nylon_amt_tpu.train import step as jstep
from nylon_amt_tpu.train.importer import build_rules as j_build_rules
from nylon_amt_tpu_torch import cli
from nylon_amt_tpu_torch import config as tconfig
from nylon_amt_tpu_torch.data.corpus import assemble_split, write_manifest
from nylon_amt_tpu_torch.data.windows import WindowDataset
from nylon_amt_tpu_torch.infer.decode import mpe2note as t_mpe2note
from nylon_amt_tpu_torch.midi.smf import write_notes as t_write_notes
from nylon_amt_tpu_torch.models import fused_train as tft
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT
from nylon_amt_tpu_torch.native import load_decoder_library
from nylon_amt_tpu_torch.train import step as tstep
from nylon_amt_tpu_torch.train.importer import build_rules as t_build_rules
from nylon_amt_tpu_torch.utils.wavio import save_wav

SMALL = dict(hid_dim=16, pf_dim=32, enc_layer=2, dec_layer=2, enc_head=2,
             dec_head=2)


def _configs(**kw):
    """(JAX config, port config) of the same small model."""
    m = {**SMALL, **kw.pop("model", {})}
    t = kw.pop("train", {})
    return (jconfig.Config(model=jconfig.ModelConfig(**m),
                           train=jconfig.TrainConfig(**t)),
            tconfig.Config(model=tconfig.ModelConfig(**m),
                           train=tconfig.TrainConfig(**t)))


def _batch(rng, B=2, valid=None):
    return {
        "spec": rng.standard_normal((B, 256, 192)).astype(np.float32),
        "onset": (rng.random((B, 128, 88)) > 0.95).astype(np.float32),
        "offset": (rng.random((B, 128, 88)) > 0.95).astype(np.float32),
        "mpe": (rng.random((B, 128, 88)) > 0.7).astype(np.float32),
        "velocity": rng.integers(0, 128, (B, 128, 88)).astype(np.int32),
        "valid": (np.ones(B, np.float32) if valid is None
                  else np.asarray(valid, np.float32)),
    }


def _port_model(params, cfg):
    model = HFT(cfg, "cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return model


# ---------------------------------------------------- the copies (repair) --

@pytest.mark.parametrize("make", ["default", "paper_bf16"])
def test_config_copy_round_trips_with_the_original(make, tmp_path):
    if make == "default":
        j, t = jconfig.Config(), tconfig.Config()
    else:
        j = jconfig.Config(model=jconfig.ModelConfig.paper_scale())
        t = tconfig.Config(model=tconfig.ModelConfig.paper_scale())
    assert t.to_dict() == j.to_dict()
    assert tconfig.Config.from_dict(j.to_dict()).to_dict() == j.to_dict()
    assert jconfig.Config.from_dict(t.to_dict()).to_dict() == t.to_dict()
    j.save(str(tmp_path / "j.json"))
    t.save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    assert tconfig.Config.load(str(tmp_path / "j.json")) == t
    with pytest.raises(ValueError, match="unknown keys"):
        tconfig.Config.from_dict({"model": {"nope": 1}})


@pytest.mark.parametrize("dec_alg", ["cafreq_satime", "cafreq"])
def test_build_rules_copy_equals_the_original(dec_alg):
    for enc_layer, dec_layer in ((2, 2), (3, 3)):
        assert t_build_rules(enc_layer, dec_layer, "cnntime_safreq",
                             dec_alg) == \
            j_build_rules(enc_layer, dec_layer, "cnntime_safreq", dec_alg)


def test_write_notes_copy_writes_identical_bytes(tmp_path):
    rng = np.random.default_rng(0)
    notes = [{"pitch": int(rng.integers(21, 109)),
              "onset": float(on), "offset": float(on + rng.random() + 0.05),
              "velocity": int(rng.integers(1, 128))}
             for on in np.sort(rng.random(40) * 20)]
    j_write_notes(str(tmp_path / "j.mid"), notes)
    t_write_notes(str(tmp_path / "t.mid"), notes)
    assert (tmp_path / "t.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()


def test_native_decoder_copy_gives_identical_notes():
    assert load_decoder_library() is not None
    rng = np.random.default_rng(1)
    T, P = 600, 88
    onset = (rng.random((T, P)) ** 6).astype(np.float32)
    offset = (rng.random((T, P)) ** 6).astype(np.float32)
    mpe = (rng.random((T, P)) ** 2).astype(np.float32)
    velocity = rng.integers(0, 128, (T, P)).astype(np.int8)
    cfg = jconfig.Config()
    for mode in ("shorter", "longer", "offset"):
        kw = dict(thred_onset=0.5, thred_offset=0.5, thred_mpe=0.5,
                  mode_offset=mode)
        want = j_mpe2note(cfg, onset, offset, mpe, velocity, **kw)
        got = t_mpe2note(tconfig.Config(), onset, offset, mpe, velocity,
                         **kw)
        assert len(want) > 10
        assert got == want


# ------------------------------------------------------------ full model --

def test_loss_and_grads_match_jax_with_dropout():
    jcfg, tcfg = _configs(model=dict(dropout=0.1),
                          train=dict(batch_size=2))
    rng = np.random.default_rng(0)
    batch = _batch(rng, valid=[1.0, 0.0])
    params = init_params(jcfg, jax.random.key(1), batch_size=2)
    key = jax.random.key(7)
    seeds = {i: int(jax.random.randint(jax.random.fold_in(key, 1000 + i),
                                       (), 0, 2 ** 31 - 1, dtype=jnp.int32))
             for i in tft.seed_slots(tcfg)}
    apply = jft.make_fused_apply(jcfg, interpret=True)
    (l_j, _), g_j = jax.value_and_grad(
        lambda p: jstep.loss_fn(jcfg, apply, p,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                key), has_aux=True)(params)

    model = _port_model(params, tcfg)
    l_t, _ = tstep.loss_fn(tcfg, tft.make_fused_apply(tcfg), model,
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


def test_train_trajectory_matches_jax():
    jcfg, tcfg = _configs(model=dict(dropout=0.0),
                          train=dict(batch_size=2, lr=1e-3))
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(3)]
    jstate = jstep.create_train_state(jcfg, jax.random.key(2), batch_size=2)
    model = _port_model(jax.tree_util.tree_map(np.asarray, jstate.params),
                        tcfg)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = tstep.TrainState(model, tstep.make_optimizer(
        tcfg, model.parameters()))
    # the key biases' gradient is zero to rounding (see the loop below)
    g0 = jax.grad(lambda p: jstep.loss_fn(
        jcfg, jstate.apply_fn, p,
        {k: jnp.asarray(v) for k, v in batches[0].items()})[0])(jstate.params)
    g0 = params_from_jax(jax.tree_util.tree_map(np.asarray, g0), tcfg)
    g_top = max(g.abs().max().item() for g in g0.values())
    key_bias = [n for n in g0 if n.endswith("fc_k.bias")]
    assert key_bias
    for name in key_bias:
        assert g0[name].abs().max().item() <= 1e-6 * g_top, (
            name, g0[name].abs().max().item(), g_top)
    j_train = jstep.make_train_step(jcfg)
    rng_key = jax.random.key(0)
    for b in batches:
        jstate, jm = j_train(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                             rng_key)
        tm = tstep.train_step(tcfg, state,
                              {k: torch.from_numpy(v) for k, v in b.items()},
                              None)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
    assert state.step == 3
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                           tcfg)
    for name, p in model.named_parameters():
        if name.endswith("fc_k.bias"):
            # the softmax is invariant to a shift of every key, so the key
            # biases have zero gradient in exact arithmetic (g0 above shows
            # it): Adam turns float noise into steps of up to lr, in either
            # framework
            err = (p.detach() - init[name]).abs().max().item()
            assert err <= 3 * 1e-3 * 1.001, (name, err)
            continue
        scale = want[name].abs().max().item()
        err = (p.detach() - want[name]).abs().max().item() / scale
        assert err <= 1e-4, (name, err)


# --------------------------------------------------------------- trainer --

def _corpus(tmp_path, tcfg):
    """Seeded synthetic train and valid splits (the port's assemble_split)."""
    rng = np.random.default_rng(11)

    def piece(n):
        feat = rng.standard_normal((n, 256)).astype(np.float32) - 4.0
        lab = {"onset": (rng.random((n, 88)) > 0.97).astype(np.float32),
               "offset": (rng.random((n, 88)) > 0.97).astype(np.float32),
               "mpe": rng.random((n, 88)) > 0.8,
               "velocity": rng.integers(0, 128, (n, 88)).astype(np.int8)}
        return feat, lab

    d = tmp_path / "corpus"
    for split, sizes in (("train", (40, 24)), ("valid", (32,))):
        pieces = [piece(n) for n in sizes]
        assemble_split(tcfg, [p[0] for p in pieces],
                       [p[1] for p in pieces]).save(str(d), split)
    write_manifest(tcfg, str(d))
    return d


def _train(cfg_path, corpus, out, *extra):
    return cli.main(["train", "--config", str(cfg_path), "--dataset",
                     str(corpus), "--out", str(out), "--n-slice", "16",
                     "--device", "cpu", *extra])


def test_cli_train_resume_and_transcribe(tmp_path):
    jcfg, tcfg = _configs(model=dict(dropout=0.0),
                          train=dict(batch_size=2, seed=5, lr=1e-3))
    cfg_path = tmp_path / "config.json"
    tcfg.save(str(cfg_path))
    corpus = _corpus(tmp_path, tcfg)
    out = tmp_path / "run"

    # the port's batches are the JAX WindowDataset's for the same seed
    from nylon_amt_tpu.data.corpus import SplitArrays as JSplitArrays
    from nylon_amt_tpu_torch.data.corpus import SplitArrays

    ds = WindowDataset(SplitArrays.load(str(corpus), "train"), tcfg, 16)
    jds = JWindowDataset(JSplitArrays.load(str(corpus), "train"), jcfg, 16)
    got = list(ds.batches(2, shuffle=True, rng=np.random.default_rng(5),
                          pad_to_batch=True))
    want = list(jds.batches(2, shuffle=True, rng=np.random.default_rng(5),
                            pad_to_batch=True))
    assert len(got) == len(want) == ds.steps_per_epoch == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    assert _train(cfg_path, corpus, out, "--epochs", "1") == 0
    perf = json.loads((out / "performance.json").read_text())
    # the keys of nylon_amt_tpu/train/loop.py's performance.json and
    # parameter.json
    assert set(perf) == {"loss_train", "loss_valid", "datetime", "lr",
                         "current_epoch", "current_div", "best_epoch",
                         "best_div", "best_loss_valid"}
    assert len(perf["loss_train"]) == 1 and np.isfinite(perf["loss_train"][0])
    assert np.isfinite(perf["loss_valid"][0])
    manifest = json.loads((out / "parameter.json").read_text())
    assert set(manifest) == {"config", "parameters", "d_output", "devices",
                             "processes", "mesh"}
    assert manifest["config"]["model"] == tcfg.to_dict()["model"]
    assert manifest["config"]["train"]["epochs"] == 1      # the CLI flag
    assert manifest["config"]["train"]["n_slice"] == 16
    ckpts = out / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["best.json", "best_epoch.txt",
                                         "model_000_000"]

    # --resume-auto continues after the last tag
    assert _train(cfg_path, corpus, out, "--epochs", "2",
                  "--resume-auto") == 0
    perf2 = json.loads((out / "performance.json").read_text())
    assert perf2["loss_train"][:1] == perf["loss_train"]
    assert len(perf2["loss_train"]) == 2 and perf2["current_epoch"] == 1
    opt = torch.load(ckpts / "model_001_000" / "optimizer.pt",
                     weights_only=True)
    assert opt["step"] == 4

    # the reference-format .dat loads in cli transcribe
    wav = tmp_path / "piece.wav"
    t = np.arange(3 * 16000) / 16000
    save_wav(str(wav), 0.3 * np.sin(2 * np.pi * 440 * t), 16000)
    rc = cli.main(["transcribe", "--checkpoint",
                   str(ckpts / "model_001_000" / "model.dat"), "--config",
                   str(cfg_path), "--wav", str(wav), "--out",
                   str(tmp_path / "midi"), "--batch-windows", "2",
                   "--device", "cpu"])
    assert rc == 0
    assert (tmp_path / "midi" / "piece.mid").exists()
