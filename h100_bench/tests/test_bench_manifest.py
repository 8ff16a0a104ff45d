"""The manifest keeps the contract's rules on names, and every cell
finds its files."""

import json
import os
import re

import pytest

from h100_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(MANIFEST) as f:
        return json.load(f)


def test_names_and_units_use_only_allowed_characters():
    m = manifest()
    names = [c["name"] for c in m["configs"]] + \
        [w["name"] for w in m["workloads"]] + \
        [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w["config"] for w in m["workloads"]]
    names += [w["traffic"] for w in m["workloads"]]
    names += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(x["unit"]) for x in m["end_to_end"] + m["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in m[group]]
        assert len(group_names) == len(set(group_names)), group
    for text in [c["why"] for c in m["configs"] + m["workloads"]] + \
            [x["layer"] for x in m["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_resolves(cell):
    m = manifest()
    c = harness.load_cell(cell)
    assert os.path.exists(c.config_path)
    with open(c.config_path) as f:
        config = json.load(f)
    entry = next(x for x in m["configs"]
                 if os.path.join(os.path.dirname(BENCH), x["file"])
                 == c.config_path)
    assert set(entry["reduced"]) <= set(config["sim"])
    assert c.traffic["pipeline"]
    assert {"snp_calling_lines", "sv_calling_lines", "snp_phasing_lines",
            "sv_phasing_lines"} <= set(c.limits)
    for name in c.end_to_end + c.per_layer:
        assert os.path.exists(os.path.join(BENCH, "metrics", name + ".py"))
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    moves = {x["name"]: x["moves"] for x in m["per_layer"]}
    assert all(moves[name] in c.end_to_end for name in c.per_layer)
