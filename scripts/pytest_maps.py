"""Memory maps held by each pytest worker, test by test.

A pytest plugin: after every test it appends the process's line count of
``/proc/self/maps`` (its memory maps; the kernel allows 65,530 a process,
``vm.max_map_count``) and the test's id to ``<MAPS_OUT>/<worker>.tsv``.
Load it into an unchanged test command through the environment:

    PYTHONPATH=scripts PYTEST_PLUGINS=pytest_maps MAPS_OUT=/tmp/maps <the test command>

Run as a script on that directory, it prints each worker's peak, its peak
in the JAX package's tests and in the port's (``test_torch_*``), and the
growth each test module caused, summed over the workers, largest first:

    python3 scripts/pytest_maps.py /tmp/maps
"""
import collections
import glob
import os
import sys
import time

_out = None


def _maps() -> int:
    with open("/proc/self/maps", "rb") as fh:
        return fh.read().count(b"\n")


def pytest_runtest_logfinish(nodeid, location):
    global _out
    if _out is None:
        directory = os.environ.get("MAPS_OUT", "maps")
        os.makedirs(directory, exist_ok=True)
        name = os.environ.get("PYTEST_XDIST_WORKER", "main")
        _out = open(os.path.join(directory, f"{name}.tsv"), "a", buffering=1)
    _out.write(f"{time.time():.1f}\t{_maps()}\t{nodeid}\n")


def report(directory: str) -> None:
    growth = collections.Counter()
    for path in sorted(glob.glob(os.path.join(directory, "gw*.tsv"))):
        rows = [line.rstrip("\n").split("\t") for line in open(path)]
        counts = [(int(n), node) for _, n, node in rows]
        port = [c for c in counts if "test_torch_" in c[1]]
        other = [c for c in counts if "test_torch_" not in c[1]]
        top = max(port) if port else (0, "")
        print(f"{os.path.basename(path)}: {len(counts)} tests, peak {max(counts)[0]}; in the JAX package's tests "
              f"{max(other)[0] if other else 0}; in the port's {top[0]} ({top[1]})")
        for (prev, _), (n, node) in zip(counts, counts[1:]):
            growth[node.split("::")[0]] += n - prev
    for module, n in growth.most_common(15):
        print(f"{n:8d} {module}")


if __name__ == "__main__":
    report(sys.argv[1])
