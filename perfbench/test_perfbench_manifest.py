"""The benchmark's manifest and data files: names, units, limits, and that
every cell's files resolve by name (CPU only)."""
import json
import re
from pathlib import Path

import pytest

from perfbench import bench, drivers

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = bench.load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_limits():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(_text_ok(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def test_names_and_units_use_allowed_characters():
    m = MANIFEST
    names = [c["name"] for c in m["configs"]] + CELLS
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w["config"] for w in m["workloads"]] + [w["traffic"] for w in m["workloads"]]
    names += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for group in (m["configs"], m["workloads"], m["end_to_end"] + m["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)


def test_entries_hold_just_their_keys():
    m = MANIFEST
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"]) and len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        # each lists its cells: the harness reads no other rule for them
        assert set(x) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert x["moves"] in e2e and _text_ok(x["layer"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c, config, traffic = bench.cell_parts(MANIFEST, cell, ROOT)
    cfg = {x["name"]: x for x in MANIFEST["configs"]}[c["config"]]
    assert cfg["file"].startswith("perfbench/") and config["name"] == cfg["name"]
    drivers.load(traffic["entry"]).check_keys(traffic)
    names = traffic["accelerators"]
    assert names == "all" or set(names) <= set(config["accelerators"])
    e2e = [x for x in MANIFEST["end_to_end"] if bench.applies(x, cell)]
    layer = [x for x in MANIFEST["per_layer"] if bench.applies(x, cell)]
    assert "setup_s" in {x["name"] for x in e2e} and len(e2e) >= 2 and layer
    for x in e2e + layer:
        assert callable(bench.reader(x["name"]).read)
        if "moves" in x:
            moved = {y["name"]: y for y in MANIFEST["end_to_end"]}[x["moves"]]
            assert bench.applies(moved, cell)


@pytest.mark.parametrize("name", sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json")))
def test_every_traffic_key_is_read_by_its_driver(name):
    """A traffic file holds only what its entry's driver reads: a setting
    the driver does not implement is refused, never run as something else."""
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())
    driver = drivers.load(traffic["entry"])
    driver.check_keys(traffic)
    with pytest.raises(ValueError, match="clients"):
        driver.check_keys(dict(traffic, clients=4))


def test_an_unknown_entry_is_refused():
    for entry in ("nosuch", "__init__", "../bench", "Pack"):
        with pytest.raises(KeyError):
            drivers.load(entry)


def test_every_config_is_used_and_its_file_is_its_own():
    m = MANIFEST
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for c in m["configs"]:
        assert any(c["file"].startswith(p + "/") for p in m["paths"])


def test_files_under_paths_are_named_from_name_characters():
    for p in MANIFEST["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


@pytest.mark.parametrize("name", ["table1.bram18", "table1.u50"])
def test_configs_hold_the_published_shapes(name):
    """Every buffer row, Table-2 row and inventory count is the program's
    published one; nothing is cut."""
    import repro_torch.core as rc

    config = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    assert config["reduced"] == []
    assert list(config["accelerators"]) == list(rc.ACCELERATORS)
    for acc, rows in config["accelerators"].items():
        assert [(n, tuple(s)) for n, s in rows] == list(rc.TABLE1_ROWS[acc])
        assert config["hyperparameters"][acc] == rc.PAPER_TABLE2[acc]
    for k in config["kinds"]:
        kind = rc.RAM_KINDS[k]
        assert [tuple(m) for m in config["ram_kinds"][k]["modes"]] == list(kind.modes)
        assert config["ram_kinds"][k]["capacity_bits"] == kind.capacity_bits
    if config["inventory"] is not None:
        inv = rc.OCM_DEVICES[config["device"]]
        assert tuple(config["inventory"][k] for k in config["kinds"]) == inv.counts
        assert tuple(config["kinds"]) == tuple(k.name for k in inv.kinds)
