"""The readings a Conformer training cell's limits are set from, at the
cell's own sizes, for several seeds in one process (``controls.py``'s, on
``reference/conformer.py``):

    python h100_bench/controls_conformer.py --workload conformer_l.train.libri --seeds 11 12 13
        [--program] [--set frontend.precision=highest] [--device cuda]

Without ``--program``: the control, the plain reference put in the
program's place at the precision below the configuration's bf16 (float8
e4m3), and the faults a training cell can have, planted in the reference
put in the program's place: ``half_batch`` (each step on the first half of
its rows) and ``state_unchanged`` (the steps leave the state as it was:
the first state's loss on each batch, no gradient norm, no change).  Each
takes the run's first steps (the first batch of each bucket of the seed's
cycle, its draws and weights) against the float32 reference; the control
and each fault have to fail at least one limit.

With ``--program``: the program's sound runs, the driver's own set-up and
first steps, against the reference (``controls.program_readings``).

Prints one JSON line a seed and reading with the numbers and the cell's
limits.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import controls, generator, run  # noqa: E402
from h100_bench.reference import compare  # noqa: E402
from h100_bench.reference.conformer import make_params, param_groups, run_steps  # noqa: E402
from h100_bench.reference.model import no_tf32  # noqa: E402

_SEED_MASK = 2 ** 63 - 1


def train_control(cfg: dict, mix: dict, seed: int, dev) -> dict:
    """{reading: numbers}: ``fp8`` (the control), ``half_batch`` and
    ``state_unchanged``."""
    seed &= _SEED_MASK
    params = make_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    cycle = generator.train_cycle(mix, seed)
    base = (seed * 1_000_003) & _SEED_MASK
    first = generator.first_steps(cycle, mix["reference_steps"])[: mix["reference_steps"]]
    batches = [{k: torch.from_numpy(getattr(cycle[i], k)).to(dev)
                for k in ("waves", "wave_lens", "targets", "target_lens")} for i in first]
    groups = param_groups(cfg)

    def steps(precision="fp32", rows=None, update=True):
        gens = [torch.Generator(device=dev).manual_seed(base + j) for j in range(len(batches))]
        cut = [{k: v[:rows] for k, v in b.items()} for b in batches]
        return run_steps(cfg, params, cut, gens, precision, update)

    ref = steps()
    return {"fp8": compare.train_gaps(steps("fp8"), ref, groups),
            "half_batch": compare.train_gaps(steps(rows=mix["rows"] // 2), ref, groups),
            "state_unchanged": compare.train_gaps(steps(update=False), ref, groups)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--set", action="append", default=[], dest="settings")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.cache_env()
    found = run.cell_of(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    cfg, mix = found["cfg"], found["mix"]
    for setting in args.settings:
        controls.override(cfg, setting)
    dev = torch.device(args.device)
    no_tf32()
    limits = compare.limits_for(args.workload)
    readings = controls.program_readings if args.program else train_control
    for seed in args.seeds:
        for reading, numbers in readings(cfg, mix, seed, dev).items():
            judged = compare.judged(numbers, limits)
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": reading,
                              "settings": args.settings, "numbers": numbers, "limits": limits,
                              "fails": [c["name"] for c in judged if not c["ok"]],
                              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                              else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
