"""Every file the benchmark finds by name is there and parses, and
BENCHMARK.json keeps to the contract's shapes."""
import glob
import json
import os
import re

import pytest

from mdbench.harness import layers, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = spec.config(c["name"])
    assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    assert c["file"] == f"mdbench/configs/{c['name']}.json"
    assert cfg["reduced"] == c["reduced"]
    assert os.path.exists(os.path.join(spec.ROOT, cfg["deck"]))
    deck = spec.deck(cfg, spec.traffic(BENCH["workloads"][0]["traffic"]), 1)
    assert os.path.exists(deck["read_data"])
    assert spec.limits(c["name"])["limits"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    tr = spec.traffic(w["traffic"])
    assert {"replicate", "thermo", "warmup_intervals",
            "trace_intervals"} <= set(tr)
    assert w["chips"] in (1, 4)
    assert len(w["why"]) <= 200
    e2e = {m["name"] for m in spec.metrics_of(BENCH, w["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, w["name"], "per_layer")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    path = os.path.join(spec.HERE, "metrics", f"{m['name']}.py")
    with open(path) as f:
        assert "def read(run)" in f.read()
    if "moves" in m:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_layer_fragments():
    frags = layers.fragments()
    assert frags and all(f and lay for f, lay in frags)
    lay = layers.LayerMap()
    assert lay("void (anonymous namespace)::pppm_gather_kernel<7>(...)") \
        == "kspace"
    assert lay("gather_kernel(float*, int)") == "rebin"
    assert lay("void cellpair_kernel<1, 1, true>(...)") == "pair"
    assert lay("void at::native::vectorized_elementwise_kernel<4>") == \
        layers.GLUE


def test_paths_hold_the_benchmark_alone():
    assert BENCH["paths"] == ["mdbench"]
    assert BENCH["command"][1] == "mdbench/run.py"
    for path in glob.glob(os.path.join(spec.HERE, "**", "*.json"),
                          recursive=True):
        with open(path) as f:
            json.load(f)
