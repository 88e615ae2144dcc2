"""BENCHMARK.json against the files it names: every cell's configuration
and traffic file, every per-layer metric's reader and every roofline group
are files of their own that the harness finds by name, so that a new one is
a new file and a new entry."""

import json
import os
import re

from conftest import ROOT

from benchmark.harness.main import cell_metrics, load_file

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_finds_its_file():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        for k in c["reduced"]:
            assert k in cfg
        assert os.path.exists(os.path.join(ROOT, "benchmark", "reference",
                                           f"{cfg['reference']}.py"))
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           f"{w['traffic']}.json"))
        e2e = {m["name"] for m in cell_metrics(b, w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell_metrics(b, w, "per_layer")
    for m in b["per_layer"]:
        assert NAME.match(m["name"])
        reader = load_file(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"),
                           "reader_" + m["name"].replace(".", "_"))
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_end_to_end_names_are_known_to_the_harness():
    for m in _bench()["end_to_end"]:
        assert m["name"].split(".")[0] in ("reads_per_s", "peak_mem_gib", "setup_s")
