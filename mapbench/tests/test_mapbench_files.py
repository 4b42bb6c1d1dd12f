"""Every file BENCHMARK.json names is there and parses, and nothing under
mapbench/ imports JAX or the JAX package (top-level names compared
whole)."""
import ast
import json
import os

import pytest

from mapbench import run
from mapbench.metrics import load as load_metric

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_parse(cell):
    spec = run.load_cell(cell)
    cfg, tr = spec["config"], spec["traffic"]
    assert cfg["mode"] in ("ls", "cs")
    assert os.path.exists(os.path.join(
        ROOT, "mapbench", "gen", f"{cfg['genome']['generator']}.py"))
    assert os.path.exists(os.path.join(
        ROOT, "mapbench", "gen", f"{tr['generator']}.py"))
    assert spec["end_to_end"] and spec["per_layer"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load(name):
    assert callable(load_metric(name).read)


def test_config_files_match_entries():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in cfg and k in cfg["published"]


def _modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_imports():
    here = os.path.join(ROOT, "mapbench")
    seen = 0
    for d, _, files in os.walk(here):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(d, fn)) as f:
                tree = ast.parse(f.read())
            for mod in _modules(tree):
                seen += 1
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "shrimp_tpu"), \
                    (fn, mod)
    assert seen > 0
