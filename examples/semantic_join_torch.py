"""Semantic join + LLM AGG + table generation (paper Table 1 Q3/Q5/Q6), on
PyTorch (the twin of examples/semantic_join.py over ``repro_torch``).

    PYTHONPATH=src python examples/semantic_join_torch.py [--device cpu]

The database's device is CUDA unless ``--device cpu`` is given.
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
    db.register_table("Movie", Table.from_rows([
        {"title": "Titanic", "plot": "romance and tragedy at sea"},
        {"title": "Alien", "plot": "graphic violence in deep space"},
        {"title": "Toy Story", "plot": "family fun with living toys"},
    ]))
    db.register_table("CastT", Table.from_rows([
        {"title": "Titanic", "cname": "James Cameron", "role": "Director"},
        {"title": "Alien", "cname": "Ridley Scott", "role": "Director"},
    ]))

    def orc(instruction, rows):
        if "maturity" in instruction and not rows:
            return [{"label": l, "description": d} for l, d in
                    [("G", "family friendly for all ages"),
                     ("R", "graphic violence or adult themes")]]
        out = []
        for r in rows:
            vals = " ".join(str(v) for v in r.values())
            out.append({
                "match": ("violence" in vals) == ("violence" in
                                                  str(r.get("m__plot", ""))
                                                  + str(r.get("plot", "")))
                and (("violence" in vals) or ("family" in vals)),
                "style": "epic" if "romance" in vals else "tense",
            })
        return out

    db.register_oracle("movies", orc)
    db.sql("CREATE LLM MODEL gem PATH 'oracle:movies' ON PROMPT")

    print("== table generation (semantic relation ρ^s) ==")
    r = db.sql("CREATE TABLE MaturityRating AS SELECT label, description "
               "FROM LLM gem (PROMPT 'Get all the maturity {label VARCHAR} "
               "and {description VARCHAR} in US')")
    print(r.table.head_repr())

    print("\n== semantic join (⋈^s): movie plots × rating descriptions ==")
    r = db.sql("SELECT m.title AS title, mr.label AS rating FROM Movie AS m "
               "JOIN MaturityRating AS mr ON LLM gem (PROMPT 'is rating "
               "{{mr.description}} depicted in {{m.plot}}')")
    print(r.table.head_repr())
    print(f"stats: calls={r.stats.llm_calls} tokens={r.stats.tokens} "
          f"(dedup hits={r.stats.cache_hits})")

    print("\n== semantic aggregate (LLM AGG) ==")
    r = db.sql("SELECT cname, LLM AGG gem (PROMPT 'summarize the "
               "cinematography {style VARCHAR} of the {{plot}}s') AS style "
               "FROM CastT NATURAL JOIN Movie GROUP BY cname")
    print(r.table.head_repr())
    return 0


if __name__ == "__main__":
    sys.exit(main())
