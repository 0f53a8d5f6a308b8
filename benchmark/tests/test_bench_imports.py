"""What ``benchmark/run.py`` loads: never JAX or the JAX package (whose
name the port's begins with, so names are compared whole), and the
reference nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run
from benchmark import harness
bench = harness.load_benchmark()
for m in bench["per_layer"]:
    harness.reader(m["name"])
for t in {{w["traffic"] for w in bench["workloads"]}}:
    harness.driver(harness.load_mix(t)["driver"])
import benchmark.trace, benchmark.calibrate, benchmark.readers
import benchmark.reference.onet, benchmark.reference.quant
# what the drivers import from the port when they run
import onet_tpu_torch.train.steps, onet_tpu_torch.train.optim
import onet_tpu_torch.models.infer, onet_tpu_torch.models.quant
import onet_tpu_torch.serve.http, onet_tpu_torch.core.policy
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.onet, benchmark.reference.quant
import benchmark.inputs.onet_weights, benchmark.traffic.frames
import benchmark.work.onet
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _tops(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, env=env, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_what_the_benchmark_loads():
    tops = _tops(LOAD_ALL)
    assert "onet_tpu_torch" in tops and "benchmark" in tops
    assert not tops & {"jax", "jaxlib", "flax", "onet_tpu"}, tops


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE_ONLY)
    assert not tops & {"onet_tpu_torch", "onet_tpu", "jax", "jaxlib"}, tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "onet_tpu_torch_x", sys)
    assert "onet_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "onet_tpu.models", sys)
    assert harness.forbidden_modules() == ["onet_tpu"]
