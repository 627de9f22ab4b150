"""Every configuration (``BENCHMARK.json`` and ``held_out.json``) brings in
its own module its CPU cut (``tiny``) and its planted fault (``alter``);
the CPU tests take them from there and from nowhere else. The cuts of the
k-NN and PageRank configurations are the numbers the tests have always
run."""

import copy
import json

import pytest

from benchmark import harness
from benchmark.tests import _tiny

BENCH = _tiny.bench()

#: what each configuration's ``tiny`` sets, in dotted keys: the cuts the
#: CPU tests ran before each configuration brought its own
CUTS = {
    "knn-1m-768": (
        {"doc_key_space": 4096, "dim": 16, "k": 4, "queries": 8,
         "scan_chunk": 512, "frontend.max_rows": 256},
        {"preload_docs": 1024, "rate_per_s": 40, "warm_s": 0.3,
         "replay.ticks": 3, "replay.writes_per_tick": 2}),
    "pagerank-1m-edges": (
        {"nodes": 2000, "edges": 20000},
        {"size.min": 200, "size.max": 200, "warm_writes": 3,
         "max_rate_per_s": 100, "replay.ticks": 3,
         "replay.writes_per_tick": 1}),
}


def _flat(d: dict, at: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{at}{k}."))
        else:
            out[f"{at}{k}"] = v
    return out


def _assert_cut(a: dict, b: dict, want: dict) -> None:
    """``b`` is ``a`` with the keys of ``want`` set, and nothing else."""
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    assert {k: fb[k] for k in want} == want
    assert {k: v for k, v in fb.items() if k not in want} == \
        {k: v for k, v in fa.items() if k not in want}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_brings_tiny_and_alter(name):
    mod = harness.load_module(_tiny.ROOT / "configs" / f"{name}.py")
    assert callable(mod.tiny) and callable(mod.alter)
    assert any(w["config"] == name for w in BENCH["workloads"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]
                                  if w["config"] in CUTS])
def test_tiny_cuts_the_numbers_the_tests_ran(name):
    c = harness.cell(BENCH, name)
    cfg0, mix0 = copy.deepcopy(c.cfg), copy.deepcopy(c.mix)
    cfg, mix = _tiny.tiny(BENCH, name)
    want_cfg, want_mix = CUTS[c.config]
    _assert_cut(cfg0, cfg, want_cfg)
    _assert_cut(mix0, mix, want_mix)
    # copies: the cell's own dicts are left as they were
    mod = harness.load_module(c.config_dir / f"{c.config}.py")
    mod.tiny(c.cfg, c.mix)
    assert (c.cfg, c.mix) == (cfg0, mix0)


@pytest.mark.parametrize("fn", ["tiny", "alter"])
def test_a_configuration_without_its_own_cut_or_fault_is_an_error(tmp_path,
                                                                  fn):
    for sub in ("configs", "traffic"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "bare.json").write_text(json.dumps({}))
    (tmp_path / "traffic" / "t.json").write_text(json.dumps({}))
    other = {"tiny": "alter", "alter": "tiny"}[fn]
    (tmp_path / "configs" / "bare.py").write_text(
        f"def {other}(*a):\n    return a\n")
    bench = {"workloads": [{"name": "bare.t", "config": "bare",
                            "traffic": "t", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    with pytest.raises(AttributeError, match=rf"bare\.py defines no "
                                             rf"function {fn}\(\)"):
        _tiny.config_fn(bench, "bare.t", fn, tmp_path)
