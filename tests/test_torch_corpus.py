"""The port's corpus path against the JAX package's, on the CPU.

* ``labels/note2label.py``: bit for bit JAX's on the inputs of
  ``tests/test_note2label.py`` and with the tablature head's ``string``
  matrix;
* ``labels/note2ref.py``: the reference texts byte-identical to JAX's;
* ``tools/proof_corpus.py``: the same MIDI bytes, samples and notes as
  ``scripts/proof_corpus.py`` for the same seed;
* ``cli corpus --device cpu`` against JAX's ``cli corpus`` on three short
  synthesized pairs: labels and ``idx`` byte-identical, the lists, ``ref/``
  texts and ``--per-file`` archives' keys equal; the features, and JAX's,
  within 2e-3 of a float64 log-mel of the same samples (the plain float32
  version reads up to 1.6e-3 from it: PERF.md). ``tests/test_torch_mel.py``'s
  tolerance (2e-4 between the two) holds on its loud noise, not here: the
  pieces' quiet stretches (log-mel down to -14) put each float32 version
  3-7e-4 from the float64 one, in other directions, and the port's reading
  moves with the thread count (the sums' order).
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

from nylon_amt_tpu import cli as jcli
from nylon_amt_tpu.config import Config as JConfig
from nylon_amt_tpu.labels import note2ref as jref
from nylon_amt_tpu.labels.note2label import note2label as j_note2label
from nylon_amt_tpu_torch import cli
from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.labels import note2ref as tref
from nylon_amt_tpu_torch.labels.note2label import note2label as t_note2label
from nylon_amt_tpu_torch.ops.mel import MelFrontend
from nylon_amt_tpu_torch.tools import proof_corpus
from nylon_amt_tpu_torch.utils.wavio import load_mono, save_wav

from test_torch_ablation import one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import proof_corpus as jproof  # noqa: E402  (scripts/proof_corpus.py)

SR = 16000
F32_REACH = 2e-3    # a float32 log-mel from the float64 one (log units)

# the inputs of tests/test_note2label.py, and the tab head's string labels
NOTE2LABEL_CASES = {
    "onset_ramp": ([{"pitch": 60, "onset": 10.0, "offset": 10.5,
                     "velocity": 77}], {}),
    "mpe_roll": ([{"pitch": 21, "onset": 0.0, "offset": 0.096,
                   "velocity": 1}], {}),
    "offset_suppressed": ([{"pitch": 60, "onset": 0.0, "offset": 1.0,
                            "velocity": 50},
                           {"pitch": 60, "onset": 1.0, "offset": 2.0,
                            "velocity": 60}], {}),
    "velocity_order": ([{"pitch": 60, "onset": 0.512, "offset": 0.7,
                         "velocity": 50},
                        {"pitch": 60, "onset": 0.544, "offset": 0.9,
                         "velocity": 90}], {}),
    "offset_duration_tolerance": ([{"pitch": 60, "onset": 0.0,
                                    "offset": 8.0, "velocity": 10}],
                                  {"offset_duration_tolerance_flag": True}),
    "out_of_range_pitch": ([{"pitch": 5, "onset": 0.0, "offset": 0.1,
                             "velocity": 10}], {}),
    "nframe": ([{"pitch": 60, "onset": 0.0, "offset": 0.1,
                 "velocity": 10}], {"nframe": 500}),
    "strings": ([{"pitch": 40, "onset": 0.2, "offset": 0.9, "velocity": 70,
                  "string": 6},
                 {"pitch": 45, "onset": 0.21, "offset": 0.5, "velocity": 90,
                  "string": 5},
                 {"pitch": 64, "onset": 0.6, "offset": 1.3, "velocity": 30},
                 {"pitch": 40, "onset": 0.9, "offset": 1.5, "velocity": 55,
                  "string": 6}], {"strings": True}),
}


@pytest.mark.parametrize("case", sorted(NOTE2LABEL_CASES))
def test_note2label_copy_is_bit_for_bit_jax(case):
    notes, kw = NOTE2LABEL_CASES[case]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = j_note2label(JConfig(), notes, **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t_note2label(Config(), notes, **kw)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert want["onset"].any() == (case != "out_of_range_pitch")


def test_note2ref_files_are_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    notes = [{"pitch": int(rng.integers(21, 109)), "onset": float(on),
              "offset": float(on + rng.random() * 0.8),
              "velocity": int(rng.integers(1, 128))}
             for on in np.sort(rng.random(30) * 6)]
    notes.append({"pitch": 60, "onset": 1.0, "offset": 1.0, "velocity": 9})
    jref.write_note_refs(notes, str(tmp_path / "j"))
    tref.write_note_refs(notes, str(tmp_path / "t"))
    for suffix in (".txt", "_velocity.txt", "_mpe_16ms.txt",
                   "_mpe_10ms.txt"):
        want = (tmp_path / f"j{suffix}").read_bytes()
        assert (tmp_path / f"t{suffix}").read_bytes() == want, suffix
        assert want
    np.testing.assert_array_equal(tref.mpe_roll(notes, 62.5),
                                  jref.mpe_roll(notes, 62.5))
    times, freqs = tref.read_mpe_ref(str(tmp_path / "t_mpe_10ms.txt"))
    jtimes, jfreqs = jref.read_mpe_ref(str(tmp_path / "t_mpe_10ms.txt"))
    np.testing.assert_array_equal(times, jtimes)
    assert all(np.array_equal(a, b) for a, b in zip(freqs, jfreqs))


def test_proof_corpus_copy_gives_the_same_piece(tmp_path):
    got_wav, got_notes = proof_corpus.synth_rich_piece(
        np.random.default_rng(7), Config(), str(tmp_path / "t.mid"), dur=4.0)
    want_wav, want_notes = jproof.synth_rich_piece(
        np.random.default_rng(7), JConfig(), str(tmp_path / "j.mid"), dur=4.0)
    assert (tmp_path / "t.mid").read_bytes() == \
        (tmp_path / "j.mid").read_bytes()
    assert got_notes == want_notes and len(got_notes) > 3
    assert got_wav.dtype == want_wav.dtype
    np.testing.assert_array_equal(got_wav, want_wav)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Three short synthesized WAV + MIDI pairs and their lists (one a
    split)."""
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(19)
    os.makedirs(d / "lists")
    for split, name in (("train", "tr0"), ("valid", "va0"), ("test", "te0")):
        wav, _ = proof_corpus.synth_rich_piece(rng, Config(),
                                               str(d / f"{name}.mid"),
                                               dur=3.0)
        save_wav(str(d / f"{name}.wav"), wav, SR)
        (d / "lists" / f"{split}.tsv").write_text(
            f"{name}\t{d / (name + '.wav')}\t{d / (name + '.mid')}\n")
    return d


def _corpus(pairs, out, *extra):
    """(port's corpus dir, JAX's corpus dir) of the same command."""
    argv = ["corpus", "--lists", str(pairs / "lists"), *extra]
    assert cli.main([*argv, "--out", str(out / "t"), "--device", "cpu"]) == 0
    jargs = jcli.build_parser().parse_args([*argv, "--out", str(out / "j")])
    assert jcli.cmd_corpus(jargs) == 0
    return out / "t", out / "j"


def _truth(wav_path) -> np.ndarray:
    """The log-mel of a WAV in float64 (the port's frames, bases and
    filterbank, widened)."""
    fe = MelFrontend(Config().feature, "cpu")
    frames = fe.frame(torch.from_numpy(load_mono(str(wav_path), SR)).double())
    re, im = frames @ fe.cos_w.double().T, frames @ fe.sin_w.double().T
    return torch.log((re * re + im * im) @ fe.fb.double()
                     + fe.cfg.log_offset).numpy()


def _close(got, want, truth, rows=slice(None)):
    """``got`` and ``want`` within ``F32_REACH`` of ``truth`` on ``rows``,
    bit for bit elsewhere (the pads)."""
    outside = np.ones(got.shape[0], bool)
    outside[rows] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    for x in (got, want):
        np.testing.assert_allclose(x[rows], truth, rtol=0, atol=F32_REACH)


def test_cli_corpus_matches_jax(pairs, tmp_path):
    t, j = _corpus(pairs, tmp_path, "--refs", "--offset-duration-tolerance")
    names = sorted(os.listdir(j))
    assert sorted(os.listdir(t)) == names
    arrays = [n for n in names if n.endswith(".npy")]
    assert len(arrays) == 3 * 6       # feature, 4 labels, idx per split
    stems = {"train": "tr0", "valid": "va0", "test": "te0"}
    for name in arrays:
        if "_feature" in name:
            truth = _truth(pairs / f"{stems[name.split('_')[0]]}.wav")
            lo = Config().input.margin_b      # one piece a split
            _close(np.load(t / name), np.load(j / name), truth,
                   slice(lo, lo + truth.shape[0]))
        else:
            assert (t / name).read_bytes() == (j / name).read_bytes(), name
    for sub in ("lists", "ref"):
        files = sorted(os.listdir(j / sub))
        assert sorted(os.listdir(t / sub)) == files and files
        for f in files:
            assert (t / sub / f).read_bytes() == (j / sub / f).read_bytes()
    assert not (t / "ref" / "tr0.txt").exists()   # valid and test only
    assert (t / "config.json").read_bytes() == (j / "config.json").read_bytes()


def test_cli_corpus_per_file_matches_jax(pairs, tmp_path):
    t, j = _corpus(pairs, tmp_path, "--per-file", "--limit", "1")
    files = sorted(os.listdir(j / "per_file"))
    assert sorted(os.listdir(t / "per_file")) == files == [
        "te0.npz", "tr0.npz", "va0.npz"]
    assert not [n for n in os.listdir(t) if n.endswith(".npy")]
    for f in files:
        got, want = np.load(t / "per_file" / f), np.load(j / "per_file" / f)
        assert sorted(got.files) == sorted(want.files)
        _close(got["feature"], want["feature"],
               _truth(pairs / f.replace(".npz", ".wav")))
        for k in want.files:
            if k != "feature":
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
