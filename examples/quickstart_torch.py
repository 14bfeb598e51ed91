"""Quickstart: semantic SQL over a product table, on PyTorch (the twin of
examples/quickstart.py over ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Registers a table, uploads two models (a deterministic oracle playing the
remote-API role, and a REAL tiny PyTorch model with grammar-forced
generation), then runs the paper's core query shapes end-to-end.  The
model runs on CUDA unless ``--device cpu`` is given.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core.database import IPDB
from repro_torch.relational.table import Table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    db = IPDB(device=args.device)
    db.register_table("Product", Table.from_rows([
        {"name": "Intel Core i7-9700K", "category": "CPU", "price": 350.0},
        {"name": "AMD Ryzen 5 5600X", "category": "CPU", "price": 280.0},
        {"name": "ASUS ROG Z390-A", "category": "Motherboard", "price": 180.0},
        {"name": "MSI B550 Tomahawk", "category": "Motherboard", "price": 160.0},
        {"name": "Corsair RM750x", "category": "PSU", "price": 110.0},
    ]))

    # --- a "remote" model (oracle-backed, like an OpenAI-compatible API) ---
    def orc(instruction, rows):
        out = []
        for r in rows:
            name = str(r.get("name", ""))
            out.append({"vendor": next((v for v in
                                        ("Intel", "AMD", "ASUS", "MSI",
                                         "Corsair") if v in name), "?"),
                        # "budget part" world knowledge lives in the model
                        "budget": any(t in name for t in
                                      ("B550", "RM750", "5600X"))})
        return out

    db.register_oracle("catalog", orc)
    db.sql("CREATE LLM MODEL o4mini PATH 'oracle:catalog' ON PROMPT "
           "API 'https://api.openai.com/v1/'")

    print("== semantic projection (table inference) ==")
    r = db.sql("SELECT name, vendor FROM LLM o4mini (PROMPT "
               "'extract the {vendor VARCHAR} from {{name}}', Product)")
    print(r.table.head_repr())
    print(f"stats: calls={r.stats.llm_calls} tokens={r.stats.tokens}\n")

    print("== semantic selection with predict pull-up ==")
    q = ("SELECT name, price FROM Product WHERE LLM o4mini (PROMPT "
         "'is {{name}} a {budget BOOLEAN} part?') = TRUE "
         "AND category = 'Motherboard'")
    print(db.explain(q))
    r = db.sql(q)
    print(r.table.head_repr())
    print(f"stats: calls={r.stats.llm_calls} (only motherboards inferred)\n")

    print("== the same query on a REAL tiny PyTorch model "
          f"(grammar-forced generation, on {db.device}) ==")
    db.sql("CREATE LLM MODEL tiny PATH 'torch:olmo-1b' ON PROMPT "
           "OPTIONS { 'batch_size': 4, 'max_str': 8 }")
    r = db.sql("SELECT name, LLM tiny (PROMPT 'guess a {color VARCHAR} "
               "for {{name}}') AS color FROM Product")
    print(r.table.head_repr())
    print("(random weights → nonsense values, but 100% schema-compliant "
          "thanks to grammar-forced decoding)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
