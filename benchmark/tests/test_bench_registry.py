"""A new configuration, mix, per-layer metric or kernel class is found by
its name, with no edit to a file that is there."""

import json
import os
import shutil

import pytest

from benchmark import harness, trace

BENCH = harness.BENCH_DIR


@pytest.fixture
def tree(tmp_path):
    """A copy of the checkout's benchmark files to add to."""
    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    return root


def test_new_files_are_found_by_name(tree):
    b = tree / "benchmark"
    cfg = json.load(open(b / "configs" / "onet64-bf16.json"))
    cfg["name"] = "onet32-bf16"
    cfg["base"] = 32
    json.dump(cfg, open(b / "configs" / "onet32-bf16.json", "w"))
    mix = json.load(open(b / "mixes" / "serve-512-b32.json"))
    mix["batch"] = 16
    json.dump(mix, open(b / "mixes" / "serve-512-b16.json", "w"))
    (b / "metrics" / "transfer_share.serve.py").write_text(
        "from benchmark.readers import class_share\n"
        "def read(rec):\n    return class_share(rec, 'serve', 'transfer')\n")
    json.dump({"class": "conv", "patterns": ["^my_new_conv_kernel$"]},
              open(b / "kernels" / "conv.my_new_conv.json", "w"))
    bench = json.load(open(tree / "BENCHMARK.json"))
    bench["configs"].append({"name": "onet32-bf16", "source": "x",
                             "file": "benchmark/configs/onet32-bf16.json",
                             "reduced": ["base"], "why": "x"})
    bench["workloads"].append({"name": "onet32-bf16.serve-512-b16",
                               "config": "onet32-bf16",
                               "traffic": "serve-512-b16", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_frames_per_s":
            m["workloads"].append("onet32-bf16.serve-512-b16")
    bench["per_layer"].append({"name": "transfer_share.serve",
                               "unit": "fraction", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "serve_frames_per_s"})
    json.dump(bench, open(tree / "BENCHMARK.json", "w"))

    bench = harness.load_benchmark(str(tree))
    wl, ce = harness.find_cell(bench, "onet32-bf16.serve-512-b16")
    assert harness.load_config(ce, str(tree))["base"] == 32
    assert harness.load_mix(wl["traffic"], str(b))["batch"] == 16
    # a metric without "workloads" goes to every cell that reports the
    # end-to-end metric it moves, the new cell too
    names = [m["name"] for m in harness.cell_metrics(
        bench, "onet32-bf16.serve-512-b16", trace=True)]
    assert "transfer_share.serve" in names
    rd = harness.reader("transfer_share.serve", str(b))
    rec = {"kind": "serve", "summary": {"device_s": 2.0,
                                        "by_class": {"transfer": 0.5}}}
    assert rd.read(rec) == 0.25
    classes = trace.kernel_classes(str(b))
    assert trace.classify("my_new_conv_kernel", classes) == "conv"
    assert trace.classify("Memcpy HtoD (Pageable -> Device)",
                          classes) == "transfer"


def test_every_named_file_exists():
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
    for w in bench["workloads"]:
        mix = harness.load_mix(w["traffic"])
        assert os.path.isfile(os.path.join(BENCH, "drivers",
                                           mix["driver"] + ".py"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
