"""How many memory maps a test process holds as JAX compiles accumulate.

XLA's CPU compiler maps memory for every executable it builds, and a
process may hold at most ``vm.max_map_count`` maps (65,530 by default on
Linux).  This runs the test files named on the command line in ONE
process (no xdist workers), counts the lines of ``/proc/self/maps`` after
every test, and prints the peak and the count after each file, as JSON;
with ``--clear`` it calls ``jax.clear_caches()`` after each file, as a
module teardown would.  The tier-1 run's workers die of segmentation
faults inside XLA's compiler (``test_hs_suite.py``'s module fixture);
this measures how close a process gets to the limit.

    JAX_PLATFORMS=cpu python probe_map_count.py [--clear] tests/test_a.py ...
"""

import json
import sys

import pytest


def map_count() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


class MapCounter:
    def __init__(self, clear: bool):
        self.clear = clear
        self.peak = 0
        self.after_file = {}

    def pytest_runtest_teardown(self, item, nextitem):
        if self.clear and (nextitem is None or nextitem.module is not item.module):
            import jax
            jax.clear_caches()

    def pytest_runtest_logfinish(self, nodeid, location):
        n = map_count()
        self.peak = max(self.peak, n)
        self.after_file[nodeid.split("::")[0]] = n


def main(argv):
    clear = "--clear" in argv
    files = [a for a in argv if a != "--clear"]
    with open("/proc/sys/vm/max_map_count") as f:
        limit = int(f.read())
    counter = MapCounter(clear)
    rc = pytest.main(["-q", "-p", "no:xdist", "-o", "addopts=",
                      "-p", "no:cacheprovider", *files], plugins=[counter])
    print(json.dumps({"clear_caches_after_each_file": clear,
                      "max_map_count": limit, "peak_maps": counter.peak,
                      "maps_after_file": counter.after_file,
                      "pytest_exit": int(rc)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
