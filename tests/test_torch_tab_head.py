"""The port's tablature head (``ModelConfig.tab_head``) against the JAX
package, on the CPU.

The cases of ``tests/test_tab_head.py`` (the model's string logits, off by
default, the two-stage requirement, the engine and fused-train paths, the
loss term only with labels, the head learning, the label raster, the
corpus round trip and gather, the transcriber's grid in both stitching
modes and its annotation, the warm-start merge, the export), each held
against the JAX function on the same weights (``params_from_jax``), plus
the ``.dat`` round trip, the int8 and bf16 engines' string head, and
``cli transcribe --tab --tab-head``.

Tolerances: logits against the flax model within 1e-4 (f32; read ~3e-6),
losses within rtol 1e-5, the string head's gradient within 5e-4 of its
largest |grad| (``tests/test_torch_train.py``'s gradient gate); the
transcribers' string grids (an argmax of logits ~3e-6 apart) equal on at
least 99.9% of cells.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nylon_amt_tpu import config as jconfig
from nylon_amt_tpu.models.hft import build_model as j_build_model
from nylon_amt_tpu.train.importer import build_rules as j_build_rules
from nylon_amt_tpu_torch import cli
from nylon_amt_tpu_torch import config as tconfig
from nylon_amt_tpu_torch.data.corpus import SplitArrays, assemble_split
from nylon_amt_tpu_torch.data.windows import WindowDataset
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.infer.tab import annotate_strings, assign_strings
from nylon_amt_tpu_torch.infer.transcribe import Transcriber
from nylon_amt_tpu_torch.labels import note2label
from nylon_amt_tpu_torch.models import fused_train as tft
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT, build_model, ported
from nylon_amt_tpu_torch.train import step as tstep
from nylon_amt_tpu_torch.train.checkpoint import load_params, merge_params
from nylon_amt_tpu_torch.train.importer import build_rules
from nylon_amt_tpu_torch.utils.wavio import save_wav

from test_torch_ablation import one_thread  # noqa: F401 (autouse)

N_STRINGS = 6
LOGIT_TOL = 1e-4
FRAMES = 32     # windows of 32 + 64 frames keep the CPU's steps short


def tab_configs(**model_kw):
    """(JAX config, port config) of one small tab-head model."""
    kw = dict(hid_dim=16, pf_dim=32, enc_layer=1, dec_layer=1, enc_head=2,
              dec_head=2, dropout=0.0, tab_head=True)
    kw.update(model_kw)
    return (jconfig.Config(input=jconfig.InputConfig(num_frame=FRAMES),
                           model=jconfig.ModelConfig(**kw),
                           train=jconfig.TrainConfig(batch_size=2,
                                                     n_slice=1)),
            tconfig.Config(input=tconfig.InputConfig(num_frame=FRAMES),
                           model=tconfig.ModelConfig(**kw),
                           train=tconfig.TrainConfig(batch_size=2,
                                                     n_slice=1)))


def _params(jcfg, seed: int):
    """Flax's own initialisation, jitted: ``init_params`` runs it op by op
    (~13 s on this CPU) and resamples it by the reference recipe (~15 s
    more), which changes nothing the tests hold."""
    model = j_build_model(jcfg)
    spec = jnp.zeros((1, jcfg.feature.n_bins, jcfg.window_frames))
    return jax.jit(lambda k: model.init({"params": k}, spec,
                                        deterministic=True))(
        jax.random.key(seed))["params"]


def _model(tcfg, params):
    model = HFT(tcfg, "cpu")
    model.load_state_dict(params_from_jax(params, tcfg))
    return model.eval()


def _batch(cfg, B=2, seed=0, with_string=True):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.input.num_frame, cfg.midi.num_note)
    batch = {
        "spec": rng.standard_normal(
            (B, cfg.feature.n_bins, cfg.window_frames)).astype(np.float32),
        "onset": (rng.random(shape) < 0.01).astype(np.float32),
        "offset": (rng.random(shape) < 0.01).astype(np.float32),
        "mpe": (rng.random(shape) < 0.05).astype(np.float32),
        "velocity": rng.integers(0, 128, shape).astype(np.int32),
    }
    if with_string:
        batch["string"] = rng.integers(0, N_STRINGS + 1, shape).astype(
            np.int32)
    return batch


@pytest.fixture(scope="module")
def tab():
    """One JAX tab-head model, its flax logits on a batch, and the port's
    model on the same weights."""
    jcfg, tcfg = tab_configs()
    params = _params(jcfg, 1)
    spec = _batch(tcfg)["spec"]
    ref = jax.jit(functools.partial(j_build_model(jcfg).apply,
                                    deterministic=True))(
        {"params": params}, jnp.asarray(spec))
    return jcfg, tcfg, params, spec, ref, _model(tcfg, params)


def _close(got, want, tol=LOGIT_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


# ---------------------------------------------------------------- model ----

def test_model_emits_string_logits(tab):
    jcfg, tcfg, params, spec, ref, model = tab
    assert ported(tcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(spec))
    assert out["string_B"].shape == (2, tcfg.input.num_frame,
                                     tcfg.midi.num_note, N_STRINGS + 1)
    sd = model.state_dict()
    assert sd["decoder_spec2midi.fc_string_time.weight"].shape == \
        (N_STRINGS + 1, 16)
    assert "fc_string_time" in params["decoder"]


def test_tab_head_off_by_default():
    _, tcfg = tab_configs(tab_head=False)
    model = build_model(tcfg, "cpu")
    assert not any("string" in k for k in model.state_dict())
    with torch.no_grad():
        assert "string_B" not in model(torch.zeros(
            1, 256, tcfg.window_frames))


def test_tab_head_requires_two_stage_decoder():
    _, tcfg = tab_configs(dec_alg="cafreq")
    with pytest.raises(ValueError, match="tab_head"):
        tcfg.validate()
    with pytest.raises(ValueError, match="tab_head"):
        build_model(tcfg, "cpu")


@pytest.mark.parametrize("path", ["forward", "per_site", "fused_train",
                                  "engine"])
def test_string_logits_match_flax(tab, path):
    """Every forward the JAX package gives ``string_B`` in: the plain twin,
    the per-site path, the fused training forward (rate 0) and the engine
    (float32), against the flax module on the same weights."""
    jcfg, tcfg, params, spec, ref, model = tab
    x = torch.from_numpy(spec)
    with torch.no_grad():
        if path == "forward":
            out = model(x)
        elif path == "per_site":
            out = model.per_site(x)
        elif path == "fused_train":
            out = tft.make_fused_apply(tcfg)(model, x)
        else:
            out = engine.forward(engine.pack_params(model, torch.float32), x,
                                 tcfg)
    for key in ("string_B", "onset_B", "velocity_B", "onset_A"):
        _close(out[key], ref[key])


@pytest.mark.parametrize("precision", ["bfloat16", "int8"])
def test_engine_string_head_in_bf16_and_int8(tab, precision):
    """The bf16 and int8 engines carry the string head, held to the f32
    flax logits on the same weights: bf16 within 1.5x the plain bf16
    forward's own distance (``chip_smoke.py``'s ``bf16_gate`` rule; read
    0.048 against 0.050), int8 within 0.25 (read 0.085; the W8A8 scheme's
    error, ``tests/test_torch_q8.py``)."""
    jcfg, tcfg, params, spec, ref, _ = tab
    t16 = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, compute_dtype="bfloat16"))
    model = _model(t16, params)
    x = torch.from_numpy(spec)
    truth = np.asarray(ref["string_B"])
    with torch.no_grad():
        plain = model(x)["string_B"].float().numpy()
        got = engine.forward(engine.pack_params(
            model, torch.bfloat16, "int8" if precision == "int8" else None),
            x, t16)["string_B"]
    assert got.shape == truth.shape
    err = np.abs(got.float().numpy() - truth).max()
    if precision == "bfloat16":
        assert err <= 1.5 * np.abs(plain - truth).max(), err
    else:
        assert err <= 0.25, err


# ----------------------------------------------------------------- loss ----

def test_loss_includes_string_term_only_with_labels(tab):
    from nylon_amt_tpu.train.step import loss_fn as j_loss_fn

    jcfg, tcfg, params, spec, ref, model = tab
    apply = j_build_model(jcfg).apply
    got, want = {}, {}
    for with_string in (True, False):
        batch = _batch(tcfg, with_string=with_string)
        jl, jm = jax.jit(lambda p, b: j_loss_fn(jcfg, apply, p, b))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            tl, tm = tstep.loss_fn(tcfg, lambda m, x, seeds: m(x), model,
                                   {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        got[with_string], want[with_string] = (float(tl), tm), (float(jl),
                                                                 jm)
        assert ("loss_string_B" in tm) == with_string == \
            ("loss_string_B" in jm)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(got[True][1]["loss_string_B"]) == pytest.approx(
        float(want[True][1]["loss_string_B"]), rel=1e-5)
    assert got[True][0] > got[False][0]
    assert got[True][0] - got[False][0] == pytest.approx(
        float(got[True][1]["loss_string_B"]), rel=1e-5)


def test_train_step_learns_string_head(tab):
    """One fused train step moves the head; its gradient is JAX's."""
    from nylon_amt_tpu.train.step import loss_fn as j_loss_fn

    jcfg, tcfg, params, spec, ref, _ = tab
    batch = _batch(tcfg, seed=3)
    jgrad = jax.jit(jax.grad(lambda p: j_loss_fn(
        jcfg, j_build_model(jcfg).apply, p,
        {k: jnp.asarray(v) for k, v in batch.items()})[0]))(params)
    want = np.asarray(jgrad["decoder"]["fc_string_time"]["kernel"]).T
    model = _model(tcfg, params).train()
    state = tstep.TrainState(model, tstep.make_optimizer(
        tcfg, model.parameters()))
    head = model.decoder_spec2midi.fc_string_time.weight
    before = head.detach().clone()
    apply = tft.make_fused_apply(tcfg)
    state.optimizer.zero_grad()
    loss, m = tstep.loss_fn(tcfg, apply, model,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    loss.backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(head.grad.numpy() / scale, want / scale,
                               atol=5e-4, rtol=0)
    state.optimizer.step()
    assert float(m["loss_string_B"].detach()) > 0
    assert not torch.equal(before, head.detach())


# ---------------------------------------------------------------- labels ----

def test_note2label_string_raster():
    from nylon_amt_tpu.labels import note2label as j_note2label

    jcfg, tcfg = tab_configs()
    notes = [{"pitch": 64, "onset": 0.5, "offset": 1.0, "velocity": 90,
              "string": 1},
             {"pitch": 45, "onset": 1.0, "offset": 1.5, "velocity": 70,
              "string": 5}]
    lab = note2label(tcfg, notes, nframe=128, strings=True)
    want = j_note2label(jcfg, notes, nframe=128, strings=True)
    assert lab.keys() == want.keys()
    for k in lab:
        np.testing.assert_array_equal(lab[k], want[k], err_msg=k)
    fps = tcfg.feature.frames_per_sec
    assert lab["string"][int(0.5 * fps + 0.5), 64 - tcfg.midi.note_min] == 1
    assert lab["string"][int(1.0 * fps + 0.5), 45 - tcfg.midi.note_min] == 5
    np.testing.assert_array_equal(lab["string"] > 0, lab["velocity"] > 0)
    assert "string" not in note2label(tcfg, notes, nframe=128)


def test_corpus_roundtrip_and_gather_with_strings(tmp_path):
    from nylon_amt_tpu.data.corpus import assemble_split as j_assemble
    from nylon_amt_tpu.data.windows import WindowDataset as JWindowDataset

    jcfg, tcfg = tab_configs()
    rng = np.random.default_rng(0)
    feats, labs = [], []
    for _ in range(2):
        feats.append(rng.standard_normal((300, 256)).astype(np.float32))
        labs.append(note2label(tcfg, [{"pitch": 60, "onset": 0.3,
                                       "offset": 0.8, "velocity": 80,
                                       "string": 3}],
                               nframe=300, strings=True))
    arrays = assemble_split(tcfg, feats, labs)
    arrays.save(str(tmp_path), "train")
    loaded = SplitArrays.load(str(tmp_path), "train")
    np.testing.assert_array_equal(np.asarray(loaded.string), arrays.string)
    batch = WindowDataset(loaded, tcfg).gather(np.array([0, 5]))
    want = JWindowDataset(j_assemble(jcfg, feats, labs), jcfg).gather(
        np.array([0, 5]))
    assert batch["string"].dtype == np.int32
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    plain = assemble_split(tcfg, feats, [{k: v for k, v in lab.items()
                                          if k != "string"} for lab in labs])
    plain.save(str(tmp_path / "plain"), "train")
    reloaded = SplitArrays.load(str(tmp_path / "plain"), "train")
    assert reloaded.string is None
    assert "string" not in WindowDataset(reloaded, tcfg).gather(np.array([0]))


# ------------------------------------------------------------- inference ----

def _grids(tab, stride: int | None):
    from nylon_amt_tpu.infer.transcribe import Transcriber as JTranscriber

    jcfg, tcfg, params, spec, ref, model = tab
    feat = np.random.default_rng(0).standard_normal(
        (200, 256)).astype(np.float32)
    jtr = JTranscriber(jcfg, params=params, batch_windows=2,
                       use_engine=False)
    ttr = Transcriber(tcfg, model, "cpu", batch_windows=2)
    if stride is None:
        return ttr.transcript(feat), jtr.transcript(feat), tcfg
    return (ttr.transcript_stride(feat, stride),
            jtr.transcript_stride(feat, stride), tcfg)


def _grid_agrees(got, want):
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.mean(got == np.asarray(want)) >= 0.999


def test_transcriber_returns_string_grid_and_annotation(tab):
    post, jpost, tcfg = _grids(tab, None)
    assert post.keys() == jpost.keys()
    assert post["string_B"].shape == post["velocity_B"].shape
    _grid_agrees(post["string_B"], jpost["string_B"])
    grid = np.zeros_like(post["string_B"])
    frame = int(1.0 * tcfg.feature.frames_per_sec + 0.5)
    grid[frame, 64 - tcfg.midi.note_min] = 2      # string 2 for E4
    notes = [{"pitch": 64, "onset": 1.0, "offset": 1.4, "velocity": 80}]
    annotated = annotate_strings(notes, grid, tcfg)
    assert annotated[0]["string"] == 2 and "string" not in notes[0]
    tab_ = assign_strings(annotated)
    assert tab_.notes[0].string == 2 and tab_.notes[0].fret == 64 - 59
    grid[frame, 64 - tcfg.midi.note_min] = 6      # infeasible: fret 24
    assert assign_strings(annotate_strings(notes, grid, tcfg)
                          ).notes[0].string != 6


def test_stride_mode_carries_string_grid(tab):
    post, jpost, _ = _grids(tab, 16)
    assert post.keys() == jpost.keys()
    assert post["string_B"].shape == post["onset_B"].shape
    _grid_agrees(post["string_B"], jpost["string_B"])
    single = Transcriber(tab[1], tab[5], "cpu", batch_windows=2
                         ).transcript(np.zeros((64, 256), np.float32),
                                      mode="single")
    assert "string_B" not in single


# ------------------------------------------------------ warm start/export ----

def test_merge_params_subset_warm_start(tmp_path):
    """A piano ``.dat`` warm-starts a tab-head model (``cli.warm_start``):
    shared tensors from the checkpoint, the head fresh; the other way
    round raises."""
    jcfg, tcfg = tab_configs()
    _, piano_cfg = tab_configs(tab_head=False)
    piano = build_model(piano_cfg, "cpu")
    torch.manual_seed(7)
    for p in piano.parameters():
        torch.nn.init.normal_(p)
    path = tmp_path / "piano.dat"
    torch.save({"model_dict": piano.state_dict()}, path)
    fresh = tstep.create_train_state(tcfg, tcfg.train.seed,
                                     "cpu").model.state_dict()
    merged = merge_params(fresh, load_params(str(path)))
    state = cli.warm_start(tcfg, str(path), None, None, "cpu")
    for k, v in state.model.state_dict().items():
        want = fresh[k] if "fc_string_time" in k else piano.state_dict()[k]
        assert torch.equal(v, want) and torch.equal(merged[k], want), k
    assert state.step == 0
    with pytest.raises(KeyError):
        merge_params(piano.state_dict(), fresh)


def test_dat_round_trip_and_the_key_table(tab, tmp_path):
    """The trainer's ``.dat`` carries the head and ``cli.load_model``
    restores it strictly; the port's key table is JAX's plus the head's two
    keys (JAX's export drops the head), and a tab-head tree needs the
    tab-head config."""
    jcfg, tcfg, params, spec, ref, model = tab
    os.makedirs(tmp_path / "ck", exist_ok=True)
    torch.save({"model_dict": model.state_dict()}, tmp_path / "ck" / "m.dat")
    back = cli.load_model(str(tmp_path / "ck" / "m.dat"), tcfg, "cpu")
    for (k, a), b in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k
    plain = j_build_rules(1, 1, "cnntime_safreq", "cafreq_satime")
    rules = build_rules(1, 1, "cnntime_safreq", "cafreq_satime",
                        tab_head=True)
    assert set(rules) - set(plain) == {
        "decoder_spec2midi.fc_string_time.weight",
        "decoder_spec2midi.fc_string_time.bias"}
    assert build_rules(1, 1) == plain
    with pytest.raises(KeyError, match="fc_string_time"):
        params_from_jax(params, dataclasses.replace(
            tcfg, model=dataclasses.replace(tcfg.model, tab_head=False)))


def test_cli_transcribe_tab_head(tab, tmp_path):
    """``cli transcribe --tab --tab-head`` writes the alphaTex of the notes
    annotated from the head's grid; without ``--tab-head`` the lowest-fret
    rule's."""
    from nylon_amt_tpu_torch.infer.tab import write_alphatex

    jcfg, tcfg, params, spec, ref, model = tab
    torch.save({"model_dict": model.state_dict()}, tmp_path / "m.dat")
    tcfg.save(str(tmp_path / "cfg.json"))
    t = np.arange(3 * 16000) / 16000
    save_wav(str(tmp_path / "piece.wav"), 0.3 * np.sin(2 * np.pi * 330 * t),
             16000)
    common = ["transcribe", "--checkpoint", str(tmp_path / "m.dat"),
              "--config", str(tmp_path / "cfg.json"), "--wav",
              str(tmp_path / "piece.wav"), "--batch-windows", "2",
              "--device", "cpu", "--tab", "--thred-onset", "0.0",
              "--thred-mpe", "0.0", "--save-posteriors"]
    for flag, out in ((["--tab-head"], "head"), ([], "rule")):
        assert cli.main(common + ["--out", str(tmp_path / out)] + flag) == 0
    notes = json.loads((tmp_path / "head" / "piece.notes.json").read_text())
    post = np.load(tmp_path / "head" / "piece.post.npz")
    assert post["string_B"].dtype == np.int8
    write_alphatex(annotate_strings(notes, post["string_B"], tcfg),
                   str(tmp_path / "want.alphatex"), title="piece")
    assert (tmp_path / "head" / "piece.alphatex").read_text() == \
        (tmp_path / "want.alphatex").read_text()
    write_alphatex(notes, str(tmp_path / "rule.alphatex"), title="piece")
    assert (tmp_path / "rule" / "piece.alphatex").read_text() == \
        (tmp_path / "rule.alphatex").read_text()
