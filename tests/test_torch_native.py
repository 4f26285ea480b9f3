"""The port's native decoder library, built by several processes at once.

Every process builds ``libnylon_decoder.so`` into one fresh cache
directory and loads it: the build writes a file of its own and installs it
with one ``os.replace``, so no process can load a half-written library.
Each process then decodes the same seeded posteriors with the library.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROCESSES = 6

_CHILD = """
import json, sys
import numpy as np
from nylon_amt_tpu_torch import Config
from nylon_amt_tpu_torch.infer.decode import mpe2note
from nylon_amt_tpu_torch.native import load_decoder_library

sys.stdin.readline()                       # start together
lib = load_decoder_library()
rng = np.random.default_rng(1)
T, P = 300, 88
onset = (rng.random((T, P)) ** 6).astype(np.float32)
offset = (rng.random((T, P)) ** 6).astype(np.float32)
mpe = (rng.random((T, P)) ** 2).astype(np.float32)
velocity = rng.integers(0, 128, (T, P)).astype(np.int8)
notes = mpe2note(Config(), onset, offset, mpe, velocity, thred_onset=0.5,
                 thred_offset=0.5, thred_mpe=0.5, mode_offset="shorter")
print(json.dumps({"loaded": lib is not None, "notes": notes}))
"""


def test_concurrent_builds_all_load_one_library(tmp_path):
    cache = tmp_path / "native"
    env = {**os.environ, "NYLON_NATIVE_CACHE": str(cache),
           "NYLON_NATIVE": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                              cwd=tmp_path, stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(PROCESSES)]
    for p in procs:                        # every child has imported by now
        p.stdin.write("go\n")              # or blocks on its first read
        p.stdin.flush()
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert all(r["loaded"] for r in results), results
    assert len(results[0]["notes"]) > 10
    assert all(r["notes"] == results[0]["notes"] for r in results)
    assert sorted(os.listdir(cache)) == ["libnylon_decoder.so"]
