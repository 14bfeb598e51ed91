"""The port's front door (``repro_torch.frontdoor``, a verbatim copy of
``repro.frontdoor``) over the port's IPDB, against the JAX package's over
its own, on the CPU:

* scripted backends (tests/helpers.py: answers and latencies a pure
  function of the prompt): the same NDJSON frames, byte for byte, from
  both packages' front doors for serial sessions, for concurrent sessions
  (and equal to the serial ones, tests/test_frontdoor.py's contract), for
  an admission 429 and for a DELETE that cancels a session within one
  flush; the DRR gates grant in the same order.  Only the trailer's
  ``wall_s`` (real time) is masked, and in concurrent runs the session
  ids (handed out in arrival order);
* one session over ``PATH 'torch:olmo-1b'`` and one over ``PATH
  'jax:olmo-1b'``, the smoke config in float32 on the same weights:
  equal rows and ExecStats;
* the port's serving drivers and example twins exit 0 on the CPU when
  asked (``--device cpu``).
"""
import importlib.util
import json
import re
import socket
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from helpers import LatencyScriptedPredictor, register_scripted

import repro.configs as JC
import repro.frontdoor as JFD
import repro_torch.configs as TC
import repro_torch.frontdoor as TFD
from repro.core.database import IPDB as JaxIPDB
from repro.relational.table import Table as JaxTable
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.core.database import IPDB as TorchIPDB
from repro_torch.models.params import params_from_jax
from repro_torch.relational.table import Table as TorchTable
from repro_torch.serving.engine import InferenceEngine as TorchEngine
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
#: package → (IPDB on the CPU, Table, front-door module)
PACKAGES = {"jax": (JaxIPDB, JaxTable, JFD),
            "torch": (lambda: TorchIPDB(device="cpu"), TorchTable, TFD)}
WALL = re.compile(rb'"wall_s": [0-9.e+-]+')
SESSION = re.compile(rb'"session": "fd[0-9]+"')


def scripted_answers(instruction, rows):
    out = []
    for r in rows:
        joined = " ".join(f"{k}={v}" for k, v in sorted(r.items()))
        h = sum(map(ord, joined)) + sum(map(ord, instruction))
        out.append({"tag": f"t{h % 5}", "flag": h % 3 == 0, "score": h % 7})
    return out


def make_db(package, *, n=24, chunk=4, workers=1, predictor=None):
    make, table, _ = PACKAGES[package]
    db = make()
    db.register_table("T", table.from_rows(
        [{"a": i, "txt": f"row {i}"} for i in range(n)]))
    pred = predictor if predictor is not None else \
        LatencyScriptedPredictor(scripted_answers, base_latency_s=0.25)
    register_scripted(db, "m", pred)
    db.set_option("chunk_size", chunk)
    db.set_option("batch_size", 4)
    db.set_option("dispatch_workers", workers)
    db.set_option("enable_pilot", False)
    return db, pred


def q(instr: str) -> str:
    return ("SELECT a, LLM m (PROMPT '" + instr +
            " {tag VARCHAR} of {{txt}}') AS t FROM T")


def post(fd, sql, tenant=""):
    """POST /query over a raw socket: (status, the NDJSON frames as raw
    lines, wall_s masked), or (status, the raw JSON body) when refused."""
    body = json.dumps({"sql": sql, "tenant": tenant,
                       "explain": False}).encode()
    with socket.create_connection((fd.host, fd.port), timeout=30) as sock:
        sock.sendall(("POST /query HTTP/1.1\r\nHost: x\r\nContent-Type: "
                      "application/json\r\nContent-Length: {}\r\nConnection:"
                      " close\r\n\r\n".format(len(body))).encode() + body)
        fp = sock.makefile("rb")
        status = int(fp.readline().split()[1])
        headers = {}
        while True:
            h = fp.readline()
            if h in (b"\r\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        if status != 200:
            return status, fp.read(int(headers.get("content-length", 0)))
        data = b""
        while True:
            size = int(fp.readline().strip() or b"0", 16)
            if size == 0:
                break
            data += fp.read(size)
            fp.read(2)
    return status, [WALL.sub(b'"wall_s": 0', line)
                    for line in data.split(b"\n") if line.strip()]


def serve(package, db, **kw):
    return PACKAGES[package][2].FrontDoor(db, **kw)


QUERIES = [("acme", q("alpha")), ("acme", q("beta")), ("zeta", q("gamma")),
           ("", q("delta"))]


def sessions(package, concurrent):
    db, _ = make_db(package)
    out = [None] * len(QUERIES)
    with db, serve(package, db, max_sessions=4, max_queued=4) as fd:
        def one(i, tenant, sql):
            out[i] = post(fd, sql, tenant)
        if not concurrent:
            for i, (tenant, sql) in enumerate(QUERIES):
                one(i, tenant, sql)
        else:
            threads = [threading.Thread(target=one, args=(i, t, s))
                       for i, (t, s) in enumerate(QUERIES)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    return out


def test_serial_sessions_byte_identical_to_jax():
    jax_out, torch_out = (sessions(p, False) for p in ("jax", "torch"))
    assert torch_out == jax_out
    for status, frames in torch_out:
        assert status == 200
        assert json.loads(frames[-1])["type"] == "trailer"
        assert len(frames) == 1 + 24 // 4 + 1      # hello, chunks, trailer


def test_concurrent_sessions_byte_identical_to_jax_and_serial():
    def masked(out):
        return [(s, [SESSION.sub(b'"session": "fd"', f) for f in frames])
                for s, frames in out]
    serial = masked(sessions("torch", False))
    for _ in range(2):
        jax_out, torch_out = (masked(sessions(p, True))
                              for p in ("jax", "torch"))
        assert torch_out == jax_out == serial


def held_db(package):
    """A scripted db whose every dispatch waits on `release`, with
    `entered` set when the first dispatch starts."""
    entered, release = threading.Event(), threading.Event()

    def gate(pred, prompts):
        entered.set()
        assert release.wait(timeout=10)
    pred = LatencyScriptedPredictor(scripted_answers, gate=gate)
    db, _ = make_db(package, predictor=pred)
    return db, pred, entered, release


def admission(package):
    db, _, entered, release = held_db(package)
    with db, serve(package, db, max_sessions=1, max_queued=0) as fd:
        first = {}
        t = threading.Thread(target=lambda: first.update(
            r=post(fd, q("adm"))))
        t.start()
        assert entered.wait(timeout=10)
        refused = post(fd, q("adm2"))
        release.set()
        t.join(timeout=30)
        return refused, first["r"]


def test_admission_429_byte_identical_to_jax():
    jax_out, torch_out = (admission(p) for p in ("jax", "torch"))
    assert torch_out == jax_out
    (status, body), (status1, frames) = torch_out
    assert status == 429 and status1 == 200
    assert json.loads(frames[-1])["status"] == "ok"


def cancelled(package):
    """DELETE /query/<id> while the session's first flush is inside the
    backend: the frames, and the dispatches before and after."""
    db, pred, entered, release = held_db(package)
    with db, serve(package, db) as fd:
        cli = PACKAGES[package][2].FrontDoorClient(fd.host, fd.port)
        h = cli.query(q("del"))
        assert entered.wait(timeout=10)
        in_flight = len(pred.dispatch_log) + 1
        assert cli.cancel(h.session_id)
        release.set()
        frames = list(h.frames())
        time.sleep(0.1)
        assert db.inference_service.session_pending(h.session_id) == 0
        for f in frames:
            if f["type"] == "trailer":
                f["stats"]["wall_s"] = 0
        return frames, in_flight, len(pred.dispatch_log)


def test_cancel_within_one_flush_byte_identical_to_jax():
    jax_out, torch_out = (cancelled(p) for p in ("jax", "torch"))
    assert torch_out == jax_out
    frames, in_flight, dispatched = torch_out
    assert frames[-1]["status"] == "cancelled"
    assert frames[-1]["stats"]["cancelled"] is True
    assert dispatched == in_flight         # nothing dispatched afterwards


def drr_order(package):
    """tests/test_frontdoor.py's post-paid DRR case on one package's gate:
    the light tenant's later waiters overtake the indebted heavy one."""
    gate = PACKAGES[package][2].DeficitRoundRobin(1, quantum=2.0)
    order = []
    gate.acquire("heavy")

    def worker(tenant, label):
        assert gate.acquire(tenant)
        order.append(label)
        gate.release(tenant, cost=1.0)
    threads = []
    for tenant, label in [("heavy", "h1"), ("heavy", "h2"),
                          ("light", "l1"), ("light", "l2")]:
        t = threading.Thread(target=worker, args=(tenant, label))
        t.start()
        time.sleep(0.05)
        threads.append(t)
    gate.release("heavy", cost=50.0)
    for t in threads:
        t.join(timeout=5)
    return order[:2], sorted(order[2:]), dict(gate.grants)


def test_drr_grants_like_jax():
    assert drr_order("torch") == drr_order("jax") == (
        ["l1", "l2"], ["h1", "h2"], {"heavy": 3, "light": 2})


# ------------------------- a model behind the front door -------------------------
def test_torch_model_session_matches_jax_model_session():
    """PATH 'torch:olmo-1b' and PATH 'jax:olmo-1b' (the smoke config, vocab
    259, here in float32 on the JAX engine's weights: each database's
    engine for the path is put in place before its first query) through
    each package's front door: equal rows and ExecStats but wall times."""
    jcfg = JC.get_smoke_config("olmo-1b").replace(vocab_size=259,
                                                  compute_dtype="float32")
    tcfg = TC.get_smoke_config("olmo-1b").replace(vocab_size=259,
                                                  compute_dtype="float32")
    je = JaxEngine(jcfg, max_len=512, seed=0, kv_layout="dense")
    te = TorchEngine(tcfg, params_from_jax(tcfg, jax.tree.map(
        np.asarray, je.params), "cpu"), max_len=512, seed=0,
        kv_layout="dense", device="cpu")
    key = ("olmo-1b", "dense", 64, None, 512, "radix", "none")
    out = {}
    for package, engines, eng in (("jax", "_jax_engines", je),
                                  ("torch", "_torch_engines", te)):
        make, table, fd_mod = PACKAGES[package]
        db = make()
        getattr(db, engines)[key] = eng
        db.register_table("Items", table.from_rows(
            [{"name": f"item {i:02d}", "kind": ("bolt", "nut")[i % 2]}
             for i in range(6)]))
        db.sql(f"CREATE LLM MODEL m PATH '{package}:olmo-1b' ON PROMPT "
               "OPTIONS { 'batch_size': 1, 'num_slots': 4, 'max_tokens': 48,"
               " 'max_str': 6 }")
        with db, fd_mod.FrontDoor(db) as fd:
            res = fd_mod.FrontDoorClient(fd.host, fd.port).query(
                "SELECT name, LLM m (PROMPT 'guess the {color VARCHAR} of "
                "the {{kind}} named {{name}}') AS color FROM Items").result()
        for k in ("wall_s", "sim_latency_s", "serial_latency_s"):
            res["stats"].pop(k, None)
        out[package] = res
    assert out["torch"]["status"] == "ok"
    assert out["torch"]["rows"] == 6
    assert out["torch"]["stats"]["decode_tokens"] > 0
    assert out["torch"] == out["jax"]
    assert te.total.prefill_tokens > 0


# ------------------------------ drivers and examples ------------------------------
def load(path):
    spec = importlib.util.spec_from_file_location(Path(path).stem,
                                                  ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry,argv", [
    ("repro_torch.launch.serve", ["--requests", "3", "--slots", "2"]),
    ("launch/serve_torch.py", ["--rows", "16"]),
    ("launch/serve_torch.py", ["--frontdoor", "--rows", "16",
                               "--sessions", "2"]),
    ("examples/quickstart_torch.py", []),
    ("examples/serve_e2e_torch.py", ["--n", "3", "--slots", "2"]),
    ("examples/semantic_join_torch.py", []),
    ("examples/train_small_torch.py", ["--steps", "2"]),
], ids=["launch.serve", "serve_torch", "serve_torch-frontdoor",
        "quickstart", "serve_e2e",
        "semantic_join", "train_small"])
def test_driver_exits_zero_on_the_cpu_when_asked(entry, argv, tmp_path,
                                                 capsys):
    if entry.endswith(".py"):
        main = load(entry).main
    else:
        main = importlib.import_module(entry).main
    if entry.endswith("train_small_torch.py"):
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    assert main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out
