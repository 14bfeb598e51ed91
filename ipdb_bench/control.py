"""The control of a cell's comparison, and the program's readings beside
it, over many seeds in one process (each seed a one-query window).

    python3 ipdb_bench/control.py --workload <cell> --seeds 11,12,13

For each seed it prints one JSON line: every number the run reads, the
program's as a sound run gives them, and the control's: ``control_gap``,
the widest gap (in the float32 reference's logits) of the token that the
reference computed in float8 (e4m3, a scale a tensor, both operands of
every matrix product) puts first among the tokens the schema allows, and
``control_err``, the widest difference of that reference's logits from
the float32 reference's over the allowed tokens, at each position of the
same prompts and served tokens.  The configuration states bfloat16;
float8 is the precision below it.  The limits in ``checks/<cell>.json``
are set from these readings (``PERF.md``).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ipdb_bench.harness import bench                       # noqa: E402


def fp8(t):
    """t rounded through float8 e4m3 with a scale for the whole tensor."""
    import torch
    amax = t.abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def in_place(numbers: dict) -> dict:
    """A run's numbers with the control in the program's place: its logit
    numbers for the program's."""
    return {**numbers, "logit_gap": numbers["control_gap"],
            "logit_err": numbers["control_err"]}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    cell = bench.Cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = bench.Run(cell, seed, 0.0, False, torch.device(args.device),
                        time.perf_counter(),
                        override={} if i == 0 else
                        {"traffic": {"warmup": {"calls": 0, "new_tokens": 0}}})
        run.control = fp8
        res = bench.execute(run)
        control_correct, _ = bench.judge(in_place(res["numbers"]),
                                         run.limits)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": control_correct,
                          **res["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    bench.setup_env()
    sys.exit(main(sys.argv[1:]))
