"""The port stands alone: no module under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``repro`` (the machine with the card has neither JAX nor ``ml_dtypes``),
and every numpy-only module the port copies equals its original after
the ``repro.`` -> ``repro_torch.`` prefix rewrite."""
import ast
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro", "flax", "optax")

VERBATIM = (["config.py", "configs/__init__.py"]
            + [f"configs/{p.name}" for p in sorted((REF / "configs").glob(
                "*.py")) if p.name != "__init__.py"]
            + [f"core/{m}.py" for m in (
                "__init__", "sizing", "bayesian", "tiers", "faults",
                "eviction", "prefetch", "dedup", "agentic", "policy",
                "cache_manager", "metrics", "projection")]
            + [f"serving/{m}.py" for m in (
                "request", "scheduler", "block_allocator", "frontend")]
            + [f"traces/{m}.py" for m in (
                "__init__", "generators", "ingest", "replay", "loadgen")])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match_reference(rel):
    original = (REF / rel).read_text()
    expected = re.sub(r"\brepro\.", "repro_torch.", original)
    assert (PORT / rel).read_text() == expected


def test_every_reference_config_is_copied():
    mine = {p.name for p in (PORT / "configs").glob("*.py")}
    assert mine == {p.name for p in (REF / "configs").glob("*.py")}
