"""How the port's CPU test modules keep their JAX references from filling a
pytest worker's memory maps.

Every XLA:CPU executable that a process compiles (or loads from the
persistent compile cache) holds memory maps of its code, and JAX keeps each
one for as long as its caches do. A worker of the full run (``-n 6``) that
runs many JAX-backed modules reached ~62,000 maps against the kernel's
per-process limit of 65,530 (``vm.max_map_count``); past it XLA segfaults in
whichever test compiles next. Two tools, both used only by the port's own
test modules:

- :func:`release_jax_programs`, an autouse module fixture: before a
  module's tests and when they are done (its module fixtures torn down
  first), JAX's caches are cleared and the executables collected. So a
  module starts without the maps of what the worker ran before it (the
  JAX package's own tests, which run first, leave up to ~41,000), and the
  maps that it makes do not outlive it. A module imports it by name::

      from torch_jax_refs import release_jax_programs  # noqa: F401

- :func:`jax_in_child`: a module-level function of a test module, run in a
  child Python process, its dict of numpy arrays handed back through an
  ``.npz`` (``repro_torch.utils.tree``'s ``flatten_dict`` and
  ``unflatten_dict`` carry nested dicts through it); for references that
  compile many programs at once, so that not even one module's worth stays
  in the worker.
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CHILD = r"""
import importlib, sys
import numpy as np
np.savez(sys.argv[3], **getattr(importlib.import_module(sys.argv[1]), sys.argv[2])(*sys.argv[4:]))
"""


def _release():
    import jax

    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def release_jax_programs():
    """Before and after a module's tests: JAX's caches cleared and the
    executables they held collected."""
    _release()
    yield
    _release()


def jax_in_child(module: str, fn: str, *args: str, out: Path, timeout: float = 300) -> dict:
    """``module.fn(*args)``, which returns a flat dict of numpy arrays, run in
    a child Python process (``tests`` and ``src`` on its path, one thread);
    its result read back from ``out`` (an ``.npz`` path)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CHILD, module, fn, str(out), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}

