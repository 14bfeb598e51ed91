"""Serving driver: bring up the engine + continuous batcher and run a
request stream (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --requests 16 --slots 4 [--schema 'topic VARCHAR,score INTEGER'] \\
        [--device cpu]

The smoke config (vocab 259), as in ``repro/launch/serve.py``.  It runs on CUDA unless
``--device cpu`` is given (without a GPU it raises).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import repro_torch.configs as C
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.grammar import Field, JsonGrammar
from repro_torch.serving.scheduler import ContinuousBatcher, Request


def parse_schema(s: str):
    fields = []
    for part in s.split(","):
        name, typ = part.strip().split()
        fields.append(Field(name, typ.upper()))
    return fields


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--schema", default="label VARCHAR")
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = C.get_smoke_config(args.arch).replace(vocab_size=259) \
        if args.smoke else C.get_config(args.arch)
    print(f"[serve] {args.arch} ({cfg.num_layers}L d={cfg.d_model}) "
          f"slots={args.slots}", flush=True)
    eng = InferenceEngine(cfg, max_len=args.max_len, device=args.device)
    grammar = JsonGrammar(parse_schema(args.schema), max_str=12)

    reqs = [Request(prompt=f"request {i}: classify this row",
                    grammar=grammar, max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    cb = ContinuousBatcher(eng, num_slots=args.slots)
    t0 = time.time()
    done = cb.run(reqs, temperature=args.temperature)
    dt = time.time() - t0

    ok = 0
    for r in done:
        if r.text and not r.error:
            json.loads(r.text)      # guaranteed by the grammar
            ok += 1
    print(f"[serve] {ok}/{len(reqs)} ok in {dt:.2f}s "
          f"({cb.stats.output_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"ticks={cb.stats.decode_steps}) on {eng.device}", flush=True)
    return 0 if ok == len(reqs) else 1


if __name__ == "__main__":
    sys.exit(main())
