"""repro_torch stands alone: no jax, nothing of repro, CUDA unless asked.

* a fresh interpreter imports every repro_torch module and finds neither
  ``jax`` nor any ``repro`` module loaded (a subprocess: this test process
  has jax loaded by tests/conftest.py);
* no file under src/repro_torch imports jax or a ``repro.`` module;
* every verbatim copy equals its original with only ``repro.`` changed to
  ``repro_torch.`` in its import lines (``configs/__init__.py`` included),
  and the copied functions (``models/moe.py::pick_num_groups``,
  ``launch/mesh.py::data_axes`` and ``axis_size``,
  ``launch/dryrun.py::model_flops``) equal theirs;
* the entry points refuse to run on the CPU unless asked: the engine, the
  database, the trainer, the serving drivers, the example twins, the
  serving step builders (``make_prefill_step`` / ``make_decode_step``),
  and the distribution layer (``launch.dist``'s process group, mesh and
  rank launcher, and with them ``init_train_state(mesh=)`` and
  ``make_train_step(mesh=)``), which runs with gloo when asked for
  ``device_type="cpu"``.
"""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro_torch.configs as TC
from repro_torch.core.database import IPDB
from repro_torch.launch import serve as SERVE
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.serving.engine import InferenceEngine
from repro_torch.training import optim as OPT

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.M)
COPIES = (["relational/" + m + ".py" for m in (
    "table", "expr", "plan", "catalog", "parser", "binder", "physical",
    "executor")]
    + ["core/" + m + ".py" for m in (
        "cancel", "faults", "snapshot", "stats", "service", "predict",
        "optimizer", "rewrite", "cascade")]
    + ["serving/tokenizer.py", "serving/grammar.py", "serving/radix.py",
       "models/config.py", "training/data.py"]
    + ["frontdoor/" + m + ".py" for m in (
        "__init__", "session", "fairness", "server", "client")]
    + sorted("configs/" + p.name for p in (SRC / "repro" / "configs").glob(
        "*.py") if p.name != "common.py"))


def _modules():
    mods = []
    for p in PORT.rglob("*.py"):
        parts = p.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(mods)


def test_import_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_or_repro_imports_in_source():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                     r"from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    hits = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
            for p in PORT.rglob("*.py") for m in bad.finditer(p.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("rel", COPIES)
def test_verbatim_copy_in_sync(rel):
    original = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == IMPORT.sub(r"\1repro_torch.", original)


#: (module, function) copied verbatim into the port's module of that name
COPIED_FUNCTIONS = [("models/moe.py", "pick_num_groups"),
                    ("launch/mesh.py", "data_axes"),
                    ("launch/mesh.py", "axis_size"),
                    ("launch/dryrun.py", "model_flops")]


@pytest.mark.parametrize("rel,fn", COPIED_FUNCTIONS)
def test_copied_function_in_sync(rel, fn):
    def source(path):
        text = path.read_text()
        start = text.index(f"\ndef {fn}(") + 1
        end = text.find("\n\n\n", start)
        return text[start:end if end >= 0 else None]
    assert source(PORT / rel) == source(SRC / "repro" / rel)


def test_entry_points_refuse_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke_config("olmo-1b").replace(vocab_size=259)
    with pytest.raises(RuntimeError, match="no GPU"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        IPDB()
    assert InferenceEngine(cfg, max_len=32, device="cpu").device.type == "cpu"
    assert IPDB(device="cpu").device.type == "cpu"
    smoke = ["--smoke", "--steps", "1", "--batch", "2", "--seq-len", "16"]
    with pytest.raises(RuntimeError, match="no GPU"):
        TR.main(smoke)
    with pytest.raises(RuntimeError, match="no GPU"):
        TR.train(smoke + ["--device", "cuda"])
    assert TR.train(smoke + ["--device", "cpu"])["state"]["step"] == 1
    with pytest.raises(RuntimeError, match="no GPU"):
        SERVE.main(["--requests", "1"])
    assert SERVE.main(["--requests", "1", "--device", "cpu"]) == 0


def _script_main(rel):
    path = SRC.parent / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("entry,argv", [
    ("repro_torch.launch.serve", ["--requests", "1"]),
    ("launch/serve_torch.py", []),
    ("launch/serve_torch.py", ["--frontdoor", "--sessions", "1"]),
    ("examples/quickstart_torch.py", []),
    ("examples/serve_e2e_torch.py", ["--n", "1"]),
    ("examples/semantic_join_torch.py", []),
    ("examples/train_small_torch.py", ["--steps", "1"]),
], ids=["launch.serve", "serve_torch", "serve_torch-frontdoor", "quickstart",
        "serve_e2e", "semantic_join", "train_small"])
def test_drivers_and_examples_refuse_cpu_unless_asked(entry, argv,
                                                      monkeypatch, tmp_path):
    """The serving drivers and the example twins run on CUDA by default:
    without a GPU they raise before any work (``--device cpu`` runs them:
    tests/test_torch_frontdoor.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = SERVE.main if entry == "repro_torch.launch.serve" else \
        _script_main(entry)
    if entry.endswith("train_small_torch.py"):
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no GPU"):
        main(argv)


def test_distribution_refuses_cpu_unless_asked(monkeypatch, tmp_path):
    """The process group, the mesh and the rank launcher default to CUDA
    with NCCL and raise without a GPU; with ``device_type="cpu"`` they run
    with gloo, and a sharded state and step built on such a mesh live on
    the CPU."""
    import torch_dist_cases as DC
    from repro_torch.launch import dist as D
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        D.init_world(0, 1, str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="no GPU"):
        D.Mesh({"data": 1, "model": 1})
    with pytest.raises(RuntimeError, match="no GPU"):
        D.run_ranks(DC.cpu_entry_ranks, 1, None)
    cfg = DC.cfg_of("dense_heads")
    with pytest.raises(RuntimeError, match="no GPU"):
        ST.init_train_state(cfg, torch.Generator().manual_seed(0))
    state = ST.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {x.device.type for x in OPT.leaves(state["params"])} == {"cpu"}
    assert D.run_ranks(DC.cpu_entry_ranks, 1, "cpu", device_type="cpu",
                       timeout_s=60) == [("cpu", 1)]


@pytest.mark.parametrize("build", ["make_prefill_step", "make_decode_step"])
def test_serving_builders_refuse_cpu_unless_asked(build, monkeypatch):
    """With no mesh the step runs where `device` says: CUDA by default,
    which raises without a GPU; "cpu" builds a step whose cache and batch
    live on the CPU."""
    from repro_torch.models.config import ShapeSpec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke_config("olmo-1b").replace(compute_dtype="float32")
    shape = ShapeSpec("s", 8, 2, "prefill")
    with pytest.raises(RuntimeError, match="no GPU"):
        getattr(ST, build)(cfg, None, shape)
    step, _ = getattr(ST, build)(cfg, None, shape, device="cpu")
    assert callable(step)
