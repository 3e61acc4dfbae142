"""A cell, its configuration of a new model family (the family's
mapping and its reference), its traffic mix with a new generator, and a
per-layer metric, added as new files (and entries in
``BENCHMARK.json``) to a copy of the benchmark, are found and run by
name, with no file of the harness edited."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pbtiny


def test_new_cell_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "perfbench"
    shutil.copytree(pbtiny.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    b = json.load(open(pbtiny.ROOT / "BENCHMARK.json"))
    # a new family: its own model_type, mapped and referenced by files
    # of its own (here on DeepSeek-V3's equations)
    (bench / "configs" / "tiny-new.json").write_text(
        json.dumps(dict(pbtiny.config("mla"), model_type="tiny_fam")))
    (bench / "families" / "tiny_fam.py").write_text(textwrap.dedent(
        '''\
        """A family added as a file."""
        from families.deepseek_v3 import (  # noqa: F401
            active_flops, kv_bytes_per_token, model_config)
        '''))
    (bench / "reference" / "tiny_fam.py").write_text(textwrap.dedent(
        '''\
        """Its reference, added as a file."""
        from reference.deepseek_v3 import Reference  # noqa: F401
        '''))
    # a new mix of a new shape: bursts of single prompts
    (bench / "traffic" / "tiny-burst.py").write_text(textwrap.dedent(
        '''\
        """Bursts of ``burst`` single prompts, one burst a ``period_s``."""
        import numpy as np

        from pb.traffic import Arrival, draw_len


        def generate(mix, rate, seconds, seed, vocab, max_len):
            rng = np.random.default_rng(seed)
            out, s, t = [], 0, 0.0
            while t < seconds:
                for _ in range(mix["burst"]):
                    n = draw_len(rng, mix["context"])
                    out.append(Arrival(t, s, 0, tuple(
                        int(x) for x in rng.integers(1, vocab, n)),
                        draw_len(rng, mix["answer"]), True))
                    s += 1
                t += mix["period_s"]
            return out
        '''))
    (bench / "traffic" / "tiny-new.json").write_text(json.dumps(
        {"generator": "tiny-burst", "burst": 3, "period_s": 0.5,
         "context": {"dist": "uniform", "min": 60, "max": 120},
         "answer": {"dist": "uniform", "min": 4, "max": 8}}))
    (bench / "cells" / "tiny-cell.json").write_text(json.dumps(
        {"config": "tiny-new", "traffic": "tiny-new", "sessions_per_s": 3.0,
         "check": {"gap_limit": 0.05, "min_tokens": 20,
                   "max_requests": 2}}))
    (bench / "metrics" / "sched.steps_total.py").write_text(textwrap.dedent(
        '''\
        """Engine steps in the window."""


        def read(ctx):
            return float(len(ctx.window.steps))
        '''))
    b["workloads"].append({"name": "tiny-cell", "config": "tiny-new",
                           "traffic": "tiny-new", "chips": 1,
                           "why": "a test cell"})
    b["per_layer"].append({"name": "sched.steps_total", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "scheduler", "moves": "output_tok_per_s",
                           "workloads": ["tiny-cell"]})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] != "setup_s":
            m["workloads"].append("tiny-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    script = textwrap.dedent(f'''\
        import json, sys, time
        sys.path[:0] = [{str(bench)!r}, {str(pbtiny.ROOT / "src")!r}]
        import torch
        import run
        from pb import spec
        torch.set_num_threads(1)
        cell = spec.load_cell("tiny-cell", run.ROOT)
        out, _, _ = run.run_cell(cell, 7, 3.0, True, "cpu", time.monotonic(),
                                 step_s=0.02)
        print(json.dumps({{"per_layer": sorted(out["metrics"]),
                           "attempted": out["attempted"],
                           "cell": cell.name, "root": str(run.ROOT)}}))
        ''')
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["root"] == str(root)
    assert "sched.steps_total" in got["per_layer"]
    assert got["attempted"] == 18           # six bursts of three
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths``, the command exits non-zero and prints no result."""
    shutil.copytree(pbtiny.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(pbtiny.ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "dsv3-docqa", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
