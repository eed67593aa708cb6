"""What runs on the card imports neither JAX nor the JAX package, compared
by whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the port either."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "orbslam3_tpu"}

HARNESS = """
import json, sys
sys.path.insert(0, sys.argv[1])
import benchmark.run, benchmark.cell, benchmark.replay, benchmark.tracing, benchmark.judge
import benchmark.record, benchmark.control, benchmark.faults
from benchmark import cell
import orbslam3_tpu_torch.system, orbslam3_tpu_torch.io.vocab_io
for m in json.load(open(sys.argv[1] + "/BENCHMARK.json"))["per_layer"]:
    cell.metric_reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import benchmark.reference.orb, benchmark.reference.match, benchmark.reference.trajectory
import benchmark.synth, benchmark.bounds
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    p = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "orbslam3_tpu_torch" in names
    assert not names & JAX, names & JAX


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & (JAX | {"orbslam3_tpu_torch"}), names & (JAX | {"orbslam3_tpu_torch"})


def test_forbidden_names_compare_whole():
    sys.path.insert(0, str(ROOT / "benchmark"))
    from benchmark.run import FORBIDDEN

    assert "orbslam3_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "orbslam3_tpu" in FORBIDDEN
