"""``BENCHMARK.json`` against the benchmark's contract, the files it
names, the shape of the result line, and the imports of every module
under ``perfbench/``: none has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (``repro_torch`` is another name)."""
from __future__ import annotations

import ast
import json
import re

import pytest

import pbtiny
from pb import spec

BENCH = json.load(open(pbtiny.ROOT / "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits 43200 s
    assert 1200 + (2 + 14 * 24) * (rs + 60) + 24 * 180 <= 43200
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[k]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_whole(w):
    """Each cell's files exist and agree, it reports setup_s, another
    end-to-end metric and a per-layer one, and every per-layer metric it
    reports moves an end-to-end metric it reports."""
    cell = spec.load_cell(w, pbtiny.ROOT)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (w, m["name"])
        assert (pbtiny.BENCH / "metrics" / f"{m['name']}.py").exists()
    chk = cell.cell["check"]
    assert chk["gap_limit"] > 0 and chk["min_tokens"] > 0
    assert cell.cell["sessions_per_s"] > 0


def test_configs_are_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(pbtiny.ROOT / c["file"]))
        assert cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert not (k.endswith("_dim") or k.endswith("_rank")
                        or "size" in k), k


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_imports():
    files = sorted(pbtiny.BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {(str(p), n) for p in files for n in _imports(p)
           if n in FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    for p in (pbtiny.BENCH / "reference").rglob("*.py"):
        assert set(_imports(p)) <= {"__future__", "importlib", "math",
                                    "typing", "torch", "reference"}, p


CACHE_BYTES = {"deepseek-v3-mla8": 8 * (512 + 64) * 2,
               "granite-moe-3b-a800m": 32 * 2 * 8 * 64 * 2}


@pytest.mark.parametrize("name", sorted(CACHE_BYTES))
def test_family_found_by_model_type(name):
    """A configuration's ``model_type`` names ``families/<model_type>.py``:
    the cache bytes of a token, worked by hand, and the program's
    configuration at the file's widths."""
    c = json.load(open(pbtiny.BENCH / "configs" / f"{name}.json"))
    fam = spec.family(c)
    assert fam.__name__ == "families." + c["model_type"]
    assert spec.kv_bytes_per_token(c) == CACHE_BYTES[name]
    cfg = spec.model_config(c, name)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size) == (
        c["num_hidden_layers"], c["hidden_size"], c["num_attention_heads"],
        c["vocab_size"])


def test_forbidden_names_are_whole_words():
    import run
    assert run.forbidden_modules(["repro_torch.serving.engine",
                                  "repro_torchx", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core.sizing", "jax.numpy",
                                  "flax", "repro_torch"]) == [
        "flax", "jax", "repro"]


def test_result_line_keys():
    """The last line's keys, each metric's value and unit, the device,
    and the check's numbers beside their limits (a CPU run at a tiny
    size: the harness's look for a card is skipped)."""
    out, lines, _ = pbtiny.run("mla", seconds=3.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert isinstance(out["correct"], bool)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}
    assert lines[-1].startswith("check served_gap")
    json.dumps(out)


def test_per_layer_counters_on_the_cpu():
    """A traced run on the CPU reads the host-side per-layer metrics
    (the device-trace ones find nothing there and are left out); the
    tiny cell re-asks documents over a shared 512-token block, so the
    prompt hit share is above 0."""
    names = ("cache.prompt_hit_share", "sched.decode_rows_mean",
             "kv.pool_used_share", "device.idle_share")
    out, _, _ = pbtiny.run("mla", seconds=6.0, trace=True, per_layer=names,
                           mix=pbtiny.MIX)
    m = out["metrics"]
    assert "device.idle_share" not in m
    assert 0.0 < m["cache.prompt_hit_share"]["value"] < 100.0
    assert m["sched.decode_rows_mean"]["value"] >= 1.0
    assert 0.0 < m["kv.pool_used_share"]["value"] < 100.0
