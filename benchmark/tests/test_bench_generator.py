"""The generator: the same seed gives the same schedule and data, every
seed the same set of sizes, gaps and operations in its own order; the
key-space guards refuse a run that would run out of ids."""

import numpy as np
import pytest
import torch

from benchmark import datagen, generator, harness
from benchmark.tests import _tiny

BENCH = _tiny.bench()
SEEDS = (3, 2 ** 35 + 11)


def _sched(mix, seed, seconds=2.0):
    warm, win = generator.schedule(mix, seed, seconds)
    return [(w.due, w.ops) for w in warm], [(w.due, w.ops) for w in win]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_schedule_is_the_seeds(name):
    mix = harness.cell(BENCH, name).mix
    a, b = _sched(mix, SEEDS[0]), _sched(mix, SEEDS[0])
    assert a == b
    c = _sched(mix, SEEDS[1])
    for phase, (x, y) in enumerate(zip(a, c)):
        assert len(x) == len(y)
        assert sorted(sum(o.values()) for _, o in x) == \
            sorted(sum(o.values()) for _, o in y)
        tot = lambda s: {k: sum(o.get(k, 0) for _, o in s) for k in mix["mix"]}
        assert tot(x) == tot(y)
        if mix["loop"] == "open":
            # the same gaps between arrivals, but for the one before the
            # first write, in the window and in the replay after it
            gaps = lambda s: np.round(np.diff([d for d, _ in s]), 9)
            assert x != y
            n = len(x) - (_replay_writes(mix) if phase else 0)
            for part in (slice(0, n), slice(n, None)):
                assert len(np.setdiff1d(gaps(x[part]),
                                        gaps(y[part]))) <= 1


def _replay_writes(mix):
    ticks, per_tick = generator.replay_size(mix)
    return ticks * per_tick


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_window_then_replay(name):
    # the window's writes, then the replay's: in an open loop every write
    # of the window is due inside it and the replay's after it
    mix = harness.cell(BENCH, name).mix
    seconds = 2.0
    warm, win = generator.schedule(mix, SEEDS[1], seconds)
    n = _replay_writes(mix)
    assert len(win) > n
    if mix["loop"] == "open":
        assert max(w.due for w in win[:-n]) < seconds
        assert min(w.due for w in win[-n:]) >= seconds


def test_data_is_the_seeds():
    g = lambda s: datagen.embeddings_int8(
        5, 8, datagen.generator(s, 12), "cpu")
    assert torch.equal(g(SEEDS[1]), g(SEEDS[1]))
    assert not torch.equal(g(SEEDS[0]), g(SEEDS[1]))
    a = datagen.web_graph(100, 1000, SEEDS[1])
    b = datagen.web_graph(100, 1000, SEEDS[1])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    i1, n1 = datagen.rewire_plan(3, 10, 1000, 100, SEEDS[1], "cpu")
    i2, n2 = datagen.rewire_plan(3, 10, 1000, 100, SEEDS[1], "cpu")
    assert np.array_equal(i1, i2) and np.array_equal(n1, n2)
    assert all(len(set(r)) == 10 for r in i1)


def _dep(name, mix=None, seed=SEEDS[0]):
    cfg, tiny_mix = _tiny.tiny(BENCH, name)
    c = harness.cell(BENCH, name)
    return harness.load_module(c.config_dir / f"{c.config}.py").Deployment(
        cfg, mix or tiny_mix, seed, "cpu"), tiny_mix


def test_key_space_guard():
    dep, mix = _dep("knn.append")
    dep.make_data(*generator.schedule(mix, SEEDS[0], 1.0))
    dep, _ = _dep("knn.append")
    with pytest.raises(ValueError, match="shorten --seconds"):
        dep.make_data(*generator.schedule(mix, SEEDS[0], 60.0))
    with pytest.raises(harness.Refused, match="shorten --seconds"):
        _tiny.run(BENCH, "knn.append", seconds=60.0)


def test_ids_held_back_run_out():
    # ids held back for a coalescer span larger than the key space refuse
    # the run rather than bring an id round within one tick
    dep, mix = _dep("knn.reembed")
    dep.cfg = dict(dep.cfg, frontend=dict(dep.cfg["frontend"],
                                          max_rows=1 << 20))
    with pytest.raises(ValueError, match="shorten --seconds"):
        dep.make_data(*generator.schedule(mix, SEEDS[0], 20.0))


@pytest.mark.parametrize("name,seconds", [("knn.append", 1.0),
                                          ("knn.reembed", 20.0)])
def test_ids_never_twice_in_one_tick(name, seconds):
    dep, mix = _dep(name, seed=SEEDS[1])
    warm, win = generator.schedule(mix, SEEDS[1], seconds)
    dep.make_data(warm, win)
    # every write touches each of its ids once, and an id again only
    # after the coalescer's span of rows (the most one tick merges)
    span = dep.cfg["frontend"]["max_rows"]
    seen, rows, again = {}, 0, 0
    infos = dep.info["warm"] + dep.info["window"]
    writes = dep.inputs(len(warm), len(win))["writes"]
    assert len(writes) == len(infos)
    for (s, _, d), info in zip(writes, infos):
        ids = np.concatenate([s, d])
        assert len(ids) == len(np.unique(ids))
        for i in ids.tolist():
            if i in seen:
                assert rows - seen[i] >= span
                again += 1
            seen[i] = rows
        rows += info["rows"]
    assert seen
    if mix["ids"] == "random":
        assert again > 0
