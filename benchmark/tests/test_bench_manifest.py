"""BENCHMARK.json against the contract's form, and every file it names
found by name."""
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    assert len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    for w in man["command"]:
        assert not w.startswith("/") and ".." not in w.split("/")
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in man["paths"]), w


def test_names_and_units(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for kind in (True, False):
        group = [n for k, n in names if k == kind]
        assert len(group) == len(set(group))


def test_configs(man):
    assert 1 <= len(man["configs"]) <= 24
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for k in c["reduced"]:  # a cut of scale, never a width
            assert not re.search(r"(hidden|dim|rank|feat|class|width)", k), k
            assert conf[k] < conf["published"][k]
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_cells_found_by_name(man):
    assert 1 <= len(man["workloads"]) <= 24
    configs = {c["name"] for c in man["configs"]}
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for sub in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(BENCH, sub[0], sub[1] + ".json")), sub
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_metrics(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert 1 <= len(man["per_layer"]) <= 128
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
    for cell in cells:  # every cell reports set-up, another end-to-end metric, a per-layer one
        assert sum(cell in m.get("workloads", cells) for m in man["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in man["per_layer"])


def test_readers_load(man):
    from benchmark import harness

    record = {"chips": 1, "epoch_s": 0.1, "trainer_init_s": 2.0, "flops_per_epoch": 1e12,
              "ranks": [{"trainer_init_s": 2.0}]}
    for m in man["per_layer"]:
        v = harness.read_metric(m["name"], record)
        assert v is None or isinstance(v, float)
