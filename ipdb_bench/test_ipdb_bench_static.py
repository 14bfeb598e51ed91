"""CPU tests of the benchmark's own files: what they import, the shape of
BENCHMARK.json, and the frozen copies of the yardstick."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ipdb_bench.harness import bench, costs, foodreviews

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH.rglob("*.py"))
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def _imports(path: Path):
    """Every module a file imports by name, `importlib` calls included."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _rel(p: Path) -> str:
    return str(p.relative_to(BENCH))


@pytest.mark.parametrize("path", SOURCES, ids=_rel)
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=_rel)
def test_reference_imports_nothing_of_the_program(path):
    for m in _imports(path):
        top = m.split(".")[0]
        assert top not in FORBIDDEN | {"repro_torch"}, (path, m)
        if top == "ipdb_bench":
            assert m.startswith("ipdb_bench.reference"), (path, m)


def test_a_run_loads_no_jax_module():
    """A small run on the CPU in a process of its own: nothing it loads has
    a forbidden top-level name (the port's name begins with the JAX
    package's, so names are compared whole)."""
    code = (
        "import sys, time, torch; sys.path[:0] = ['src', '.'];"
        "from ipdb_bench.harness import bench;"
        "from ipdb_bench import test_ipdb_bench_faults as F;"
        "F.execute_small('olmo-1b.sql-topic-dense');"
        "print(bench.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ------------------------------ BENCHMARK.json ------------------------------
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["ipdb_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_cell_finds_its_files_and_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    used = set()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cell = bench.Cell(w["name"], SPEC)
        used.add(w["config"])
        assert cell.traffic["kind"] in ("sql", "train")
        assert (BENCH / "harness" / f"{cell.traffic['kind']}_cell.py").exists()
        assert cell.limits and cell.checks["small_limits"], \
            f"no checks/{w['name']}.json"
        reported = cell.end_to_end()
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer(), w["name"]
    assert used == {c["name"] for c in SPEC["configs"]}


def test_per_layer_metrics_move_what_their_cells_report():
    cells = {w["name"] for w in SPEC["workloads"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"], m["name"]
        for c in m["workloads"]:
            assert c in cells
            assert m["moves"] in bench.Cell(c, SPEC).end_to_end(), (m, c)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_kernel_metrics_name_a_wrapper_of_the_port():
    from repro_torch.kernels import ops
    kernel = [m["name"] for m in SPEC["per_layer"]
              if hasattr(bench.metric_module(m["name"]), "WRAPS")]
    assert kernel
    for name in kernel:
        mod = bench.metric_module(name)
        assert callable(getattr(ops, mod.WRAPS)), name
        assert hasattr(getattr(ops, mod.WRAPS), "launches"), name
        assert mod.PEAK in costs.PEAK_FLOPS and callable(mod.count), name
        assert name.endswith("_roofline"), name


def test_configs_hold_what_is_run():
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert f["model"]["name"] == c["name"]
        for k in c["reduced"]:
            assert NAME.match(k)


# ------------------------------ frozen copies ------------------------------
def test_foodreviews_is_the_papers_generator():
    rows = foodreviews.make_foodreviews(seed=1)
    assert len(rows) == 1014
    assert rows[0] == {"rid": 0, "review":
                       "the burger and fries were tasty #visit0",
                       "label_gt": "food"}
    assert sum(r["label_gt"] == "food" for r in rows) == 573


def test_each_query_reads_fresh_rows_and_a_seed_repeats():
    seed = 2**31 + 12345
    tables = [foodreviews.fresh_table(seed, k) for k in range(4)]
    tags = [r["review"].split("#")[1] for t in tables for r in t]
    assert len(tags) == len(set(tags)) == 4 * 1014
    assert tables[1] == foodreviews.fresh_table(seed, 1)
    assert all(len(t) == 1014 and set(t[0]) == {"rid", "review"}
               for t in tables)
    other = foodreviews.fresh_table(seed + 1, 1)
    assert [r["review"] for r in other] != [r["review"] for r in tables[1]]
    assert {len(r["review"].split("#visit")[1]) for r in other} == {7}


def test_fewshot_preamble_size_and_characters():
    p = foodreviews.fewshot_preamble(7, 4096)
    assert len(p.encode()) == 4096
    assert not set(p) & set("{}'\"")
    assert foodreviews.fewshot_preamble(7, 4096) == p


def test_decode_attention_bytes_by_hand():
    cost = costs.KernelCost("bf16")
    q = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    k = torch.zeros(2, 5, 2, 8, dtype=torch.bfloat16)
    spos = torch.tensor([[0, 1, 2, -1, -1], [0, -1, -1, -1, -1]])
    costs.decode_attention(cost, q, k, spos)
    # q + out: 2*2*4*8*2; 4 valid slots of K and V: 4*2*2*8*2; positions
    assert cost.totals() == (256 + 256 + 2 * 5 * 4 + 2 * 4, 4 * 4 * 4 * 8)


def test_paged_attention_counts_a_shared_page_once():
    cost = costs.KernelCost("bf16")
    q = torch.zeros(2, 2, 4, dtype=torch.bfloat16)
    pool = torch.zeros(1, 6, 4, 4, dtype=torch.bfloat16)
    table = torch.tensor([[0, 1, 2], [0, 3, 5]], dtype=torch.int32)
    qpos = torch.tensor([9, 5])
    costs.decode_attention_paged(cost, q, pool, table, qpos)
    # pages 0 (4 tokens, both rows), 1 (4), 2 (2), 3 (2): 12 tokens of K+V
    kv = 12 * 2 * 1 * 4 * 2
    assert cost.totals() == (2 * 2 * 2 * 4 * 2 + 6 * 4 + 2 * 4 + kv,
                             (10 + 6) * 4 * 2 * 4)


def test_sample_and_scan_bytes_by_hand():
    cost = costs.KernelCost("fp32")
    mask = torch.zeros(2, 10, dtype=torch.int8)
    mask[0, :3] = 1
    mask[1, 5] = 1
    costs.constrained_sample(cost, torch.zeros(2, 10), mask, None)
    assert cost.totals() == (20 + 8 + 4 * 4, 12)
    cost = costs.KernelCost("fp32")
    costs.selective_scan(cost, torch.zeros(3, 2, 5, dtype=torch.bfloat16), 4)
    assert cost.totals() == (3 * 2 * 5 * 10 + 2 * 3 * 2 * 4 * 2 + 5 * 4 * 4
                             + 5 * 4 + 2 * 3 * 5 * 4 * 4, 6 * 3 * 2 * 5 * 4)


def test_flop_counts():
    # 2 layers, 3 heads of 4: positions 3..5 see 4, 5 and 6 keys
    assert costs.attention_flops(2, 3, 4, 3, 6) == 4 * 2 * 3 * 4 * (4 + 5 + 6)
    assert costs.attention_flops(1, 1, 1, 0, 3) == 4 * 6
    assert costs.serve_flops(10, 7) == 140
