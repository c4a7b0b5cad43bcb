"""``calibrate.py``'s reading of a seed, which sets a cell's limits on the
card, at each cell's tiny form on the CPU: it reads the cell's own
end-to-end metrics and its driver's control, whatever the family."""

import pytest

import calibrate
from harness import check, registry

BENCH = registry.spec()
SEED = 2 ** 31 + 54321


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_reading_has_the_cells_metrics_and_its_control(tiny, name):
    line = calibrate.reading(name, SEED, 0.0, "cpu", 0.0)
    wl = tiny.workload(name)
    assert line["correct"] is True, line["program"]
    assert set(line["metrics"]) == {
        m["name"] for m in registry.cell_metrics(BENCH, name, False)}
    assert all(v > 0 for v in line["metrics"].values()), line["metrics"]
    assert set(wl["limits"]) <= set(line["program"])
    assert set(wl["limits"]) <= set(line["control"])
    assert not check.judge(line["control"], wl["limits"])[0], line["control"]
