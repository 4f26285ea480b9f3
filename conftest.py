"""Build the reference package's native decoder once, before any test runs.

``nylon_amt_tpu/native/build.py`` compiles ``decoder.cpp`` straight onto one
cached library path. Under pytest-xdist every worker imports
``tests/test_native_decoder.py`` while collecting, and each would run that
build at the same time: a worker that loads a half-written file gets None
and skips the module's tests. The controller's ``pytest_configure`` runs
before any worker starts, so building here leaves the workers a whole
library to load. The module is loaded by path, so no JAX import happens
here.
"""

import importlib.util
from pathlib import Path


def pytest_configure(config):
    path = Path(__file__).parent / "nylon_amt_tpu" / "native" / "build.py"
    spec = importlib.util.spec_from_file_location("_nylon_native_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.build()
