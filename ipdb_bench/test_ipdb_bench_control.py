"""The control of each SQL cell's comparison: the float32 reference put in
the program's place, computed in float8 (the precision below the bfloat16
the configurations state), has to fail one of the cell's logit limits on
every seed, while the program passes them.

On the CPU at the configurations' small sizes (``test_ipdb_bench_faults``'
sizes), and on the card at each cell's own size (marked ``cuda``; run on
the chip by ``python -m pytest --noconftest -p no:cacheprovider
ipdb_bench/test_ipdb_bench_control.py``).
"""
import time

import pytest
import torch

from ipdb_bench import control
from ipdb_bench import test_ipdb_bench_faults as F
from ipdb_bench.harness import bench

SEEDS = (2**31 + 7, 2**31 + 8, 2**31 + 9)
few_threads = F.few_threads
card = F.card


def readings(name: str, device: str, small: bool):
    cell = bench.Cell(name)
    out = []
    for i, seed in enumerate(SEEDS):
        over = F.small(cell) if small else {}
        if i:
            over.setdefault("traffic", {})
            over["traffic"] = {**over["traffic"],
                               "warmup": {"calls": 0, "new_tokens": 0}}
        run = bench.Run(cell, seed, 0.0, False, torch.device(device),
                        time.perf_counter(), override=over)
        run.control = control.fp8
        res = bench.execute(run)
        out.append(res["numbers"])
    return run.limits, out


def check(limits, got):
    """The program judged correct by the cell's limits, and the control,
    judged in the program's place, not, on every seed."""
    for r in got:
        assert bench.judge(r, limits)[0], r
        assert not bench.judge(control.in_place(r), limits)[0], r


@pytest.mark.parametrize("name", F.SQL_CELLS)
def test_control_fails_the_limit_at_a_small_size(name):
    check(*readings(name, "cpu", small=True))


@pytest.mark.cuda
@pytest.mark.parametrize("name", F.SQL_CELLS)
def test_control_fails_the_limit_at_the_cells_size(card, name):
    check(*readings(name, "cuda", small=False))
