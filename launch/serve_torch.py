"""Deployable serving driver for the semantic-SQL engine on PyTorch
(``repro_torch``; the twin of launch/serve.py).

Default mode runs the in-process path: bind a demo catalog, register an
oracle-backed model (playing the remote-API role), and execute the
paper's core query shapes through ``IPDB.sql``.  The database's device
is CUDA unless ``--device cpu`` is given.

``--frontdoor`` starts the HTTP serving tier instead: an asyncio front
door streaming NDJSON chunks over localhost, driven by two tenants of
``FrontDoorClient`` sessions so the fair-sharing gate, admission
control, and per-session stats are exercised end to end.  Add
``--hold`` to keep the server up afterwards for manual curl sessions:

    PYTHONPATH=src python launch/serve_torch.py --frontdoor [--hold] \
        [--port 8080] [--sessions 3] [--rows 96] [--device cpu]

    curl -N -X POST localhost:8080/query \
        -d '{"sql": "SELECT ...", "tenant": "me"}'
    curl localhost:8080/stats
"""
import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core.database import IPDB
from repro_torch.frontdoor import FrontDoor, FrontDoorClient, QueryRejected
from repro_torch.relational.table import Table


def build_db(rows: int, device="cuda") -> IPDB:
    db = IPDB(device=device)
    cats = ["CPU", "Motherboard", "PSU", "GPU"]
    db.register_table("Product", Table.from_rows([
        {"name": f"part-{i:04d}", "category": cats[i % len(cats)],
         "price": 40.0 + 7.0 * (i % 50)} for i in range(rows)]))

    def orc(instruction, rws):
        return [{"vendor": ["Intel", "AMD", "ASUS", "MSI"][
                    sum(map(ord, str(r.get("name", "")))) % 4],
                 "budget": float(r.get("price", 0.0)) < 150.0}
                for r in rws]

    db.register_oracle("catalog", orc)
    db.sql("CREATE LLM MODEL o4mini PATH 'oracle:catalog' ON PROMPT "
           "API 'https://api.openai.com/v1/'")
    db.set_option("chunk_size", 16)
    return db


def run_inprocess(args) -> int:
    db = build_db(args.rows, args.device)
    print("== in-process: semantic projection ==")
    r = db.sql("SELECT name, vendor FROM LLM o4mini (PROMPT "
               "'extract the {vendor VARCHAR} from {{name}}', Product)")
    print(r.table.head_repr())
    print(f"stats: calls={r.stats.llm_calls} tokens={r.stats.tokens}\n")
    print("== in-process: selection with predict pull-up ==")
    r = db.sql("SELECT name, price FROM Product WHERE LLM o4mini (PROMPT "
               "'is {{name}} a {budget BOOLEAN} part?') = TRUE "
               "AND category = 'PSU'")
    print(r.table.head_repr())
    print(f"stats: calls={r.stats.llm_calls} (only PSUs inferred)")
    return 0


def drive_frontdoor(fd: FrontDoor, sessions: int) -> None:
    """Two tenants over the HTTP path: `batch` streams full-table
    projections on several concurrent sessions while `interactive` fires
    point queries; per-tenant latency shows the fair gate at work."""
    cli = FrontDoorClient(fd.host, fd.port)
    lat = {"batch": [], "interactive": []}
    lock = threading.Lock()

    def issue(tenant: str, sql: str) -> None:
        t0 = time.time()
        try:
            res = cli.query(sql, tenant=tenant).result()
        except QueryRejected as e:
            print(f"  [{tenant}] rejected: {e.payload}")
            return
        with lock:
            lat[tenant].append(time.time() - t0)
        print(f"  [{tenant}] {res['rows']} rows ({res['status']}) in "
              f"{lat[tenant][-1]*1e3:.0f}ms "
              f"(dispatch_batches={res['stats']['dispatch_batches']})")

    big = ("SELECT name, LLM o4mini (PROMPT 'extract the {vendor VARCHAR}"
           " from {{name}}') AS vendor FROM Product")
    small = ("SELECT name, price FROM Product WHERE LLM o4mini (PROMPT "
             "'is {{name}} a {budget BOOLEAN} part?') = TRUE LIMIT 4")
    threads = [threading.Thread(target=issue, args=("batch", big))
               for _ in range(sessions)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    for _ in range(3):
        issue("interactive", small)
    for t in threads:
        t.join()
    for tenant, xs in lat.items():
        if xs:
            print(f"  {tenant}: n={len(xs)} "
                  f"mean={sum(xs)/len(xs)*1e3:.0f}ms "
                  f"max={max(xs)*1e3:.0f}ms")
    print(f"  server: {cli.server_stats()}")


def run_frontdoor(args) -> int:
    db = build_db(args.rows, args.device)
    with db, FrontDoor(db, host="127.0.0.1", port=args.port,
                       max_sessions=args.sessions + 1,
                       max_queued=2 * (args.sessions + 1),
                       tenant_weights={"interactive": 2.0}) as fd:
        print(f"front door listening on http://{fd.host}:{fd.port} "
              f"(max_sessions={fd.max_sessions}, gate={type(fd.gate).__name__})")
        print(f"== driving {args.sessions} batch sessions + "
              "3 interactive point queries ==")
        drive_frontdoor(fd, args.sessions)
        if args.hold:
            print("holding for manual sessions — Ctrl-C to stop")
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                print("shutting down")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frontdoor", action="store_true",
                    help="serve over the HTTP front door instead of "
                         "in-process")
    ap.add_argument("--port", type=int, default=0,
                    help="front-door port (0 = ephemeral)")
    ap.add_argument("--sessions", type=int, default=3,
                    help="concurrent batch-tenant sessions to drive")
    ap.add_argument("--rows", type=int, default=96,
                    help="demo table size")
    ap.add_argument("--hold", action="store_true",
                    help="keep the front door up after the demo drive")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.frontdoor:
        return run_frontdoor(args)
    return run_inprocess(args)


if __name__ == "__main__":
    sys.exit(main())
