"""repro_torch stands alone: no jax, nothing of repro, CUDA unless asked.

* a fresh interpreter imports every repro_torch module and finds neither
  ``jax`` nor any ``repro`` module loaded (a subprocess: this test process
  has jax loaded by tests/conftest.py);
* no file under src/repro_torch imports jax or a ``repro.`` module;
* every verbatim copy equals its original with only ``repro.`` changed to
  ``repro_torch.`` in its import lines;
* the entry points refuse to run on the CPU unless asked.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro_torch.configs as TC
from repro_torch.core.database import IPDB
from repro_torch.launch import train as TR
from repro_torch.serving.engine import InferenceEngine

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
    + sorted("configs/" + p.name for p in (SRC / "repro" / "configs").glob(
        "*.py") if p.name not in ("__init__.py", "common.py")))


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
