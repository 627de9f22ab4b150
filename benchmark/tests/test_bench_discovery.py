"""A configuration, a mix and a per-layer metric added as new files (and
new entries in BENCHMARK.json) are found by name, with no existing file
edited."""

import hashlib
import json
import shutil

from benchmark.tests import _tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_new_config_mix_and_metric_are_found(tmp_path):
    src = _tiny.ROOT
    root = tmp_path / "benchmark"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    bench = json.loads((src.parent / "BENCHMARK.json").read_text())
    before = _digests(root)
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
