"""A configuration, a mix and a per-layer metric added as new files (and
new entries in BENCHMARK.json) are found by name, with no existing file
edited: a copy of the k-NN configuration, and a configuration of a new
shape (``tests/added/``: group means of vectors, ``{group: vector}``,
the table config 5's image-embed ETL serves) that brings its own CPU
cut, planted fault, plain reference, mix and reader."""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

from benchmark import generator, harness
from benchmark.tests import _tiny

#: the files a later change adds for the configuration of a new shape,
#: laid out as in the benchmark's folder
ADDED = Path(__file__).resolve().parent / "added"


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def _copy(tmp_path):
    """A copy of the benchmark's folder, ``BENCHMARK.json`` and the
    digests of the copy's files."""
    root = tmp_path / "benchmark"
    shutil.copytree(_tiny.ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    bench = json.loads((_tiny.ROOT.parent / "BENCHMARK.json").read_text())
    return root, bench, _digests(root)


def test_new_config_mix_and_metric_are_found(tmp_path):
    root, bench, before = _copy(tmp_path)
    # a new configuration: a smaller corpus, its own files
    cfg = json.loads((root / "configs" / "knn-1m-768.json").read_text())
    cfg["name"] = "knn-small"
    (root / "configs" / "knn-small.json").write_text(json.dumps(cfg))
    shutil.copy(root / "configs" / "knn-1m-768.py",
                root / "configs" / "knn-small.py")
    shutil.copy(root / "reference" / "knn-1m-768.py",
                root / "reference" / "knn-small.py")
    # a new mix: data only
    mix = json.loads((root / "traffic" / "append.json").read_text())
    mix["rate_per_s"] = 30
    (root / "traffic" / "trickle.json").write_text(json.dumps(mix))
    # a new per-layer metric: a reader of its own
    (root / "layer_metrics" / "knn.ticks_per_s.py").write_text(
        "def read(run):\n"
        "    return len({w.tick for w in run.in_window}) / run.seconds\n")
    bench["configs"].append({"name": "knn-small", "source": "x",
                             "file": "benchmark/configs/knn-small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "knn.trickle", "config": "knn-small",
                               "traffic": "trickle", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "knn.ticks_per_s", "unit": "1/s",
                               "better": "higher", "source": "program_counter",
                               "layer": "scheduler and executor",
                               "moves": "device_rows_per_s",
                               "workloads": ["knn.trickle"]})
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    r = _tiny.run(bench, "knn.trickle", trace=True, root=root)
    assert r["correct"] is True
    assert r["metrics"]["knn.ticks_per_s"]["value"] > 0
    r = _tiny.run(bench, "knn.trickle", root=root)
    # the card's rate of rows is read from the device's trace alone
    assert set(r["metrics"]) == {"setup_s"}


def test_a_configuration_of_a_new_shape_needs_new_files_alone(tmp_path):
    root, bench, before = _copy(tmp_path)
    for p in sorted(ADDED.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            dst = root / p.relative_to(ADDED)
            assert not dst.exists(), dst
            shutil.copy(p, dst)
    bench["configs"].append({"name": "vec-groups", "source": "x",
                             "file": "benchmark/configs/vec-groups.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "groups.regroup",
                               "config": "vec-groups", "traffic": "regroup",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "groups.rows_per_tick",
                               "unit": "rows/tick", "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler and executor",
                               "moves": "device_rows_per_s",
                               "workloads": ["groups.regroup"]})
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    name = "groups.regroup"
    cfg, mix = _tiny.tiny(bench, name, root)
    tables = []

    def keep(dep, phase, out):
        if phase == "output":
            tables.append(out)
        return out

    # found and correct, traced and untraced; its reader reports
    r = _tiny.run(bench, name, trace=True, root=root)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["groups.rows_per_tick"]["value"] > 0
    r = _tiny.run(bench, name, root=root, hook=keep)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"setup_s"}
    (table,) = tables
    assert table and all(np.shape(v) == (cfg["dim"],)
                         for v in table.values())
    # its own planted fault makes a run not correct
    r = _tiny.run(bench, name, root=root,
                  hook=_tiny.altered(bench, name, root))
    assert r["correct"] is False, r["checks"]
    # its control (its reference's, judged by its own judge; both from
    # the copy) fails the comparison
    limits = cfg["checks"]
    ref = harness.load_module(root / "reference" / "vec-groups.py")
    for seed in (5, 2 ** 36 + 1, 77):
        warm, window = generator.schedule(mix, seed, 1.0)
        dep = harness.load_module(root / "configs" / "vec-groups.py"
                                  ).Deployment(cfg, mix, seed, "cpu")
        dep.make_data(warm, window)
        inputs = dep.inputs(len(warm), len(window))
        got = ref.judge(cfg, inputs, ref.control(cfg, inputs, "cpu"), "cpu")
        assert [k for k in limits if got[k] > limits[k]], got
