"""Repository-wide pytest hooks (tests/conftest.py holds the JAX
package's own).

The JAX package's native data library (native/libtdr_dataio.so) is built
by its loader on first use with `make -C native` and no lock
(textualdegremoval_tpu/data/native.py:27-32).  Under xdist every worker
imports it at collection, and in a fresh tree one worker can load the
half-written library that another's `make` is writing: its tests then
skip as if g++ were missing.  So the controller runs that very command
once, before it starts the workers (xdist starts them at session start,
after configure), and every worker finds the library built.  Nothing of
the JAX package is imported here: its data package would bring JAX in
before tests/conftest.py sets XLA_FLAGS.  Without make or g++ the build
fails quietly and the tests skip as before.
"""

import os
import subprocess

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built
        return
    if os.path.exists(os.path.join(_NATIVE, "libtdr_dataio.so")):
        return
    try:
        subprocess.run(["make", "-C", _NATIVE], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass
