"""The port's batch transcription and scoring flow (``cli transcribe --list
--int8 --tab --sheet --save-posteriors``, then ``cli evaluate``) against
the JAX package's, on a seeded lists directory, and the port's copies of
``data/lists.py``, ``labels/midi2note.py``, ``metrics/`` and
``infer/{tab,sheet}.py`` against their originals."""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from nylon_amt_tpu import cli as jcli
from nylon_amt_tpu.config import Config, ModelConfig
from nylon_amt_tpu.data.lists import CorpusList as JCorpusList
from nylon_amt_tpu.infer import sheet as jsheet
from nylon_amt_tpu.infer import tab as jtab
from nylon_amt_tpu.labels import midi2note as j_midi2note
from nylon_amt_tpu.metrics import harness as jharness
from nylon_amt_tpu.metrics import multipitch as jmp
from nylon_amt_tpu.metrics import transcription as jtr
from nylon_amt_tpu.midi.smf import write_notes
from nylon_amt_tpu.models.hft import init_params
from nylon_amt_tpu.models.init import reference_initialize
from nylon_amt_tpu.utils.wavio import save_wav
from nylon_amt_tpu_torch import cli
from nylon_amt_tpu_torch.data.lists import CorpusList
from nylon_amt_tpu_torch.infer import sheet as tsheet
from nylon_amt_tpu_torch.infer import tab as ttab
from nylon_amt_tpu_torch.labels import midi2note as t_midi2note
from nylon_amt_tpu_torch.metrics import harness as tharness
from nylon_amt_tpu_torch.metrics import multipitch as tmp_
from nylon_amt_tpu_torch.metrics import transcription as ttr
from nylon_amt_tpu_torch.models.convert import params_from_jax
from nylon_amt_tpu_torch.models.hft import HFT

SR = 16000


def _piece(rng, seconds=3.0):
    """A WAV of decaying sines and its reference notes."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    wav = 0.03 * rng.standard_normal(n)
    notes = []
    for start in np.arange(0.1, seconds - 0.6, 0.4):
        pitch = int(rng.integers(48, 80))
        f = 440.0 * 2 ** ((pitch - 69) / 12)
        s = int(start * SR)
        tt = t[s:s + SR // 2] - start
        wav[s:s + SR // 2] += 0.3 * np.exp(-4 * tt) * np.sin(2 * np.pi * f * tt)
        notes.append({"pitch": pitch, "onset": float(start),
                      "offset": float(start + 0.45),
                      "velocity": int(rng.integers(40, 110))})
    return wav.astype(np.float32), notes


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A lists dir of two test pieces (WAV + reference MIDI), a seeded
    model saved as a reference ``.dat``, and ``transcribe --list --int8
    --tab --sheet --save-posteriors`` run through the port's CLI."""
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    cfg = Config(model=ModelConfig(hid_dim=32, pf_dim=64, enc_layer=2,
                                   dec_layer=2, enc_head=2, dec_head=2,
                                   dropout=0.0))
    cfg.save(str(tmp / "config.json"))
    key = jax.random.key(5)
    params = reference_initialize(
        jax.jit(lambda k: init_params(cfg, k, reference_init=False))(key), key)
    model = HFT(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    torch.save({"model_dict": model.state_dict()}, tmp / "model.dat")
    cl = JCorpusList()
    refs = {}
    for i in range(2):
        wav, notes = _piece(rng)
        name = f"test_{i:03d}"
        save_wav(str(tmp / f"{name}.wav"), wav, SR)
        write_notes(str(tmp / f"{name}.mid"), notes)
        cl.add("test", name, str(tmp / f"{name}.wav"), str(tmp / f"{name}.mid"))
        refs[name] = notes
    cl.save(str(tmp / "lists"))
    rc = cli.main(["transcribe", "--checkpoint", str(tmp / "model.dat"),
                   "--config", str(tmp / "config.json"), "--list",
                   str(tmp / "lists"), "--split", "test", "--out",
                   str(tmp / "out"), "--batch-windows", "2", "--int8",
                   "--tab", "--sheet", "--save-posteriors", "--device", "cpu"])
    # a noisy copy of each reference as a second estimate, so the scores
    # are not all zero or one
    for name, notes in refs.items():
        est = [dict(n, onset=n["onset"] + float(rng.normal(0, 0.03)),
                    offset=n["offset"] + float(rng.normal(0, 0.1)))
               for n in notes[1:]]
        with open(tmp / "out" / f"{name}_noisy.notes.json", "w") as f:
            json.dump(est, f)
    return SimpleNamespace(tmp=tmp, cfg=cfg, rc=rc, names=sorted(refs))


def test_transcribe_list_writes_every_artifact(corpus):
    assert corpus.rc == 0
    for name in corpus.names:
        for suffix in (".mid", ".notes.json", "_1st.notes.json",
                       "_2nd.notes.json", ".alphatex", ".musicxml",
                       ".post.npz"):
            assert (corpus.tmp / "out" / f"{name}{suffix}").exists(), suffix
        post = np.load(corpus.tmp / "out" / f"{name}.post.npz")
        assert set(post.files) == {f"{k}_{f}" for k in
                                   ("onset", "offset", "mpe", "velocity")
                                   for f in ("A", "B")}


@pytest.mark.parametrize("suffix", [".notes.json", "_noisy.notes.json"])
def test_tab_and_sheet_bytes_equal_jax(corpus, tmp_path, suffix):
    """The CLI's .alphatex / .musicxml, and the copies' output on the noisy
    notes, byte-identical to the JAX writers on the same notes."""
    for name in corpus.names:
        with open(corpus.tmp / "out" / f"{name}{suffix}") as f:
            notes = json.load(f)
        for jmod, tmod, fn, ext in ((jtab, ttab, "write_alphatex",
                                     ".alphatex"),
                                    (jsheet, tsheet, "write_musicxml",
                                     ".musicxml")):
            want, got = tmp_path / f"j{ext}", tmp_path / f"t{ext}"
            getattr(jmod, fn)(notes, str(want), title=name)
            getattr(tmod, fn)(notes, str(got), title=name)
            assert got.read_bytes() == want.read_bytes(), (name, ext)
            if suffix == ".notes.json":
                cli_file = corpus.tmp / "out" / f"{name}{ext}"
                assert cli_file.read_bytes() == want.read_bytes(), ext
        assert dataclasses.asdict(ttab.assign_strings(notes)) == \
            dataclasses.asdict(jtab.assign_strings(notes))
        assert ttab.to_alphatex(notes, title=name) == \
            jtab.to_alphatex(notes, title=name)
        assert tsheet.to_musicxml(notes) == jsheet.to_musicxml(notes)


def _evaluate(main_args, tmp_path, suffix):
    """(port JSON, JAX JSON) of ``evaluate`` with the same arguments."""
    args = main_args + ["--suffix", suffix]
    assert cli.main(["evaluate", *args, "--out", str(tmp_path / "t.json")]) \
        == 0
    jargs = jcli.build_parser().parse_args(
        ["evaluate", *args, "--out", str(tmp_path / "j.json")])
    assert jcli.cmd_evaluate(jargs) == 0
    return (json.loads((tmp_path / "t.json").read_text()),
            json.loads((tmp_path / "j.json").read_text()))


@pytest.mark.parametrize("suffix", [".notes.json", "_1st.notes.json",
                                    "_noisy.notes.json", ".mid", ".post.npz"])
def test_evaluate_list_equals_jax(corpus, tmp_path, suffix):
    got, want = _evaluate(["--config", str(corpus.tmp / "config.json"),
                           "--list", str(corpus.tmp / "lists"), "--split",
                           "test", "--est-dir", str(corpus.tmp / "out")],
                          tmp_path, suffix)
    assert got == want
    scored = got.get("mpe_posterior", got["note"])["per_file"]
    assert len(scored) == 2
    if suffix == "_noisy.notes.json":
        f1 = got["note"]["mean"]["F-measure"]
        assert 0.0 < f1 < 1.0, f1


def test_evaluate_pairs_equal_jax(corpus, tmp_path):
    out = corpus.tmp / "out"
    pairs = [f"{corpus.tmp / name}.mid:{out / name}_noisy.notes.json"
             for name in corpus.names]
    pairs.append(f"{corpus.tmp / corpus.names[0]}.mid:"
                 f"{corpus.tmp / corpus.names[1]}.mid")
    got, want = _evaluate(["--pair", *pairs], tmp_path, ".notes.json")
    assert got == want


def test_no_input_returns_2(corpus):
    ckpt = str(corpus.tmp / "model.dat")
    assert cli.main(["transcribe", "--checkpoint", ckpt, "--config",
                     str(corpus.tmp / "config.json"), "--device", "cpu"]) == 2
    assert cli.main(["evaluate"]) == 2


def test_host_copies_equal_their_originals(corpus):
    lists = str(corpus.tmp / "lists")
    assert CorpusList.load(lists).entries == JCorpusList.load(lists).entries
    for name in corpus.names:
        midi = str(corpus.tmp / f"{name}.mid")
        assert t_midi2note(corpus.cfg, midi) == j_midi2note(corpus.cfg, midi)
    rng = np.random.default_rng(9)
    ref = [{"pitch": int(p), "onset": float(o), "offset": float(o + d),
            "velocity": int(v)} for p, o, d, v in zip(
        rng.integers(40, 90, 60), rng.uniform(0, 20, 60),
        rng.uniform(0.05, 1.0, 60), rng.integers(1, 127, 60))]
    est = [dict(n, onset=n["onset"] + float(rng.normal(0, 0.04)),
                pitch=n["pitch"] + int(rng.random() < 0.1))
           for n in ref if rng.random() < 0.85]
    assert tharness.score_notes(ref, est) == jharness.score_notes(ref, est)
    assert tharness.score_frames(ref, est) == jharness.score_frames(ref, est)
    post = rng.random((1300, 88))
    assert tharness.score_mpe_posteriors(ref, post) == \
        jharness.score_mpe_posteriors(ref, post)
    riv, rp, _ = jtr.notes_to_arrays(ref)
    eiv, ep, _ = jtr.notes_to_arrays(est)
    assert ttr.match_notes(riv, rp, eiv, ep) == jtr.match_notes(riv, rp, eiv,
                                                                ep)
    freqs = [np.sort(rng.uniform(50, 2000, rng.integers(0, 5)))
             for _ in range(200)]
    est_f = [f * (1 + 0.001 * rng.standard_normal(f.shape)) for f in freqs]
    assert tmp_.evaluate_frames(freqs, est_f) == jmp.evaluate_frames(freqs,
                                                                     est_f)
