"""Reference-file emitters for external scoring tools.

The port's copy of ``nylon_amt_tpu/labels/note2ref.py`` (numpy only, the
same code).

Behavioral port of ``corpus/conv_note2ref.py``: given note events, write

* ``{stem}.txt`` — onset/offset/pitch-Hz intervals (mir_eval transcription
  reference format; zero-duration notes dropped — ref ``:41-44``);
* ``{stem}_velocity.txt`` — onset/offset/pitch/velocity;
* ``{stem}_mpe_16ms.txt`` / ``{stem}_mpe_10ms.txt`` — ragged multi-pitch
  time series at the 16 ms (62.5 fps) and 10 ms grids (ref ``:51-90``).

Our own metric harness scores note lists directly; these files exist for
interop with mir_eval-based external tooling.
"""

from __future__ import annotations

import numpy as np

NUM_PITCH = 128


def note_to_freq(note_number: int) -> float:
    """ref ``conv_note2ref.py:6-7``."""
    return 440.0 * 2.0 ** ((int(note_number) - 69) / 12)


def write_interval_refs(notes: list[dict], stem: str) -> None:
    """Write ``{stem}.txt`` and ``{stem}_velocity.txt``."""
    with open(stem + ".txt", "w", encoding="utf-8") as f1, \
            open(stem + "_velocity.txt", "w", encoding="utf-8") as f2:
        for n in notes:
            if n["offset"] - n["onset"] > 0.0:
                f1.write(f"{n['onset']}\t{n['offset']}\t"
                         f"{note_to_freq(n['pitch'])}\n")
                f2.write(f"{n['onset']}\t{n['offset']}\t{n['pitch']}\t"
                         f"{n['velocity']}\n")


def mpe_roll(notes: list[dict], fps: float) -> np.ndarray:
    """Boolean ``[n_frames, 128]`` roll at the given grid (inclusive offsets,
    ref ``:59-68``)."""
    duration = max((n["offset"] for n in notes), default=0.0)
    n_frames = int(duration * fps + 0.5) + 1
    roll = np.zeros((n_frames, NUM_PITCH), dtype=bool)
    for n in notes:
        a = int(n["onset"] * fps + 0.5)
        b = int(n["offset"] * fps + 0.5)
        roll[a : b + 1, n["pitch"]] = True
    return roll


def write_mpe_refs(notes: list[dict], stem: str) -> None:
    """Write ``{stem}_mpe_16ms.txt`` and ``{stem}_mpe_10ms.txt``."""
    for fps, tag, step, nd in ((62.5, "16ms", 0.016, 3),
                               (100.0, "10ms", 0.01, 2)):
        roll = mpe_roll(notes, fps)
        with open(f"{stem}_mpe_{tag}.txt", "w", encoding="utf-8") as f:
            for i in range(roll.shape[0]):
                f.write(str(round(i * step, nd)))
                for j in np.flatnonzero(roll[i]):
                    f.write("\t" + str(note_to_freq(int(j))))
                f.write("\n")


def read_mpe_ref(path: str) -> tuple[np.ndarray, list[np.ndarray]]:
    """Parse a ragged multi-pitch txt -> (times, per-frame freq arrays)."""
    times, freqs = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            times.append(float(parts[0]))
            freqs.append(np.array([float(p) for p in parts[1:]]))
    return np.asarray(times), freqs


def write_note_refs(notes: list[dict], stem: str) -> None:
    """All four reference files for one piece."""
    write_interval_refs(notes, stem)
    write_mpe_refs(notes, stem)
