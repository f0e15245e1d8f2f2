"""The benchmark's files: every name in BENCHMARK.json has its file, names
and units are legal, and nothing under portbench/ imports JAX or the JAX
package (nor the reference anything of the port)."""
import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file(), c["file"]
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (HERE / "reference" / f"{cfg['reference']}.py").is_file()
    for w in BENCH["workloads"]:
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (HERE / "layer_metrics" / f"{m['name']}.py").is_file()


def test_names_units_and_links():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"])


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "realvsr_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "realvsr_tpu_torch" not in _imports(path)
