"""The ``catalog`` mix gives every seed the same work on the card: each
write carries exactly 360 images, so its delta rows (an insert and a
delete one each, a move two) lie in (256, 512] and every replayed tick,
one write each, forwards one 512-row capacity through the ViT, at the
parent commit and at any later one; and the replay's rows are the same
for every seed."""

import numpy as np
import pytest

from benchmark import generator, harness
from benchmark.tests import _tiny

from reflow_tpu_torch.executors.device_delta import bucket_capacity

BENCH = _tiny.bench()
CELL = "embed.vitb16"
SEEDS = range(1, 201)


def _rows(w) -> int:
    return w.ops.get("insert", 0) + 2 * w.ops.get("move", 0) \
        + w.ops.get("delete", 0)


@pytest.fixture(scope="module")
def schedules():
    mix = harness.cell(BENCH, CELL).mix
    seconds = float(BENCH["run_seconds"])
    return mix, {s: generator.schedule(mix, s, seconds) for s in SEEDS}


def test_every_replayed_tick_forwards_one_512_row_capacity(schedules):
    mix, by_seed = schedules
    ticks, per_tick = generator.replay_size(mix)
    assert per_tick == 1
    for seed, (warm, window) in by_seed.items():
        for w in warm + window:
            assert sum(w.ops.values()) == 360
            assert 256 < _rows(w) <= 512, (seed, w.ops)
        replay = window[-ticks:]
        assert [bucket_capacity(_rows(w)) for w in replay] == [512] * ticks


def test_the_replay_carries_the_same_rows_for_every_seed(schedules):
    mix, by_seed = schedules
    ticks, _ = generator.replay_size(mix)
    totals = {sum(_rows(w) for w in window[-ticks:])
              for _warm, window in by_seed.values()}
    assert totals == {ticks * 360 * 5 // 4}


def _dep(seed):
    cfg, mix = _tiny.tiny(BENCH, CELL)
    c = harness.cell(BENCH, CELL)
    return harness.load_module(c.config_dir / f"{c.config}.py").Deployment(
        cfg, mix, seed, "cpu"), mix


def test_ids_never_twice_in_one_tick():
    # every write touches each of its ids once, and an id again only
    # after the coalescer's span of rows (the most one tick merges)
    dep, mix = _dep(2 ** 35 + 11)
    warm, win = generator.schedule(mix, 2 ** 35 + 11, 2.0)
    dep.make_data(warm, win)
    span = dep.cfg["frontend"]["max_rows"]
    seen, rows, again = {}, 0, 0
    infos = dep.info["warm"] + dep.info["window"]
    writes = dep.inputs(len(warm), len(win))["writes"][1:]
    assert len(writes) == len(infos)
    for (ids, _groups, _images, drop), info in zip(writes, infos):
        touched = np.concatenate([ids, drop])
        assert len(touched) == len(np.unique(touched))
        for i in touched.tolist():
            if i in seen:
                assert rows - seen[i] >= span
                again += 1
            seen[i] = rows
        rows += info["rows"]
    assert again > 0


def test_a_run_that_would_run_out_of_ids_is_refused():
    dep, mix = _dep(3)
    with pytest.raises(ValueError, match="shorten --seconds"):
        dep.make_data(*generator.schedule(mix, 3, 60.0))
