"""End-to-end serving driver on PyTorch (the twin of examples/serve_e2e.py
over ``repro_torch``): a small model serving batched requests with
continuous batching, grammar-constrained decoding, and shared-prefix KV
reuse — the engine that PREDICT drives, exercised directly.

    PYTHONPATH=src python examples/serve_e2e_torch.py [--arch olmo-1b] \
        [--n 12] [--device cpu]

It runs on CUDA unless ``--device cpu`` is given.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import repro_torch.configs as C
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.grammar import Field, JsonGrammar
from repro_torch.serving.scheduler import ContinuousBatcher, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = C.get_smoke_config(args.arch).replace(vocab_size=259)
    print(f"model: {args.arch} (smoke config, "
          f"{cfg.num_layers}L d={cfg.d_model})")
    eng = InferenceEngine(cfg, max_len=512, device=args.device)

    # 1) batched generate with a shared instruction prefix (KV reuse)
    g = JsonGrammar([Field("sentiment", "BOOLEAN"),
                     Field("topic", "VARCHAR")], max_str=8)
    prefix = ("SYSTEM: You are a review classifier. Return JSON with "
              "sentiment and topic.\n")
    prompts = [f"review {i}: this product is great" for i in range(4)]
    t0 = time.time()
    res = eng.generate(prompts, grammar=g, shared_prefix=prefix,
                       max_new_tokens=64, temperature=0.8)
    print(f"\nbatched generate ({len(prompts)} reqs, shared prefix): "
          f"{time.time()-t0:.2f}s wall")
    for p, t in zip(prompts, res.texts):
        print(f"  {p[:24]!r} -> {t}")
    print(f"  prefill_tokens={res.stats.prefill_tokens} "
          f"decode_steps={res.stats.decode_steps}")

    res2 = eng.generate(["another review"], grammar=g, shared_prefix=prefix,
                        max_new_tokens=64)
    print(f"  2nd call prefix-hit={res2.stats.prefix_hits} "
          f"prefill_tokens={res2.stats.prefill_tokens} (prefix reused)")

    # 2) continuous batching over a request stream
    reqs = [Request(prompt=f"classify item {i}", grammar=g,
                    max_new_tokens=64) for i in range(args.n)]
    cb = ContinuousBatcher(eng, num_slots=args.slots)
    t0 = time.time()
    done = cb.run(reqs, temperature=0.9)
    dt = time.time() - t0
    ok = sum(1 for r in done if r.text and not r.error)
    print(f"\ncontinuous batching: {len(reqs)} requests on "
          f"{args.slots} slots in {dt:.2f}s ({ok} ok)")
    print(f"  ticks={cb.stats.decode_steps} "
          f"tokens out={cb.stats.output_tokens}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
