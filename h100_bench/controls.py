"""The readings a training cell's limits are set from, at the cell's own
sizes, for several seeds in one process:

    python h100_bench/controls.py --workload <cell> --seeds 11 12 13 [--program]
        [--set frontend.precision=highest] [--device cuda]

Without ``--program``: the control, the plain reference put in the
program's place at the precision below the configurations' bf16
convolutions (float8 e4m3, ``reference/model.py``), and the fault a
training cell can have, planted in the reference put in the program's
place: ``half_batch`` (each step on the first half of its rows, the mean
over them).  Each takes the run's first steps (the first batch of each
bucket of the seed's cycle, its draws and weights) against the float32
reference; the control, and each fault, has to fail at least one limit.

With ``--program``: the program's sound runs, the driver's own set-up and
first steps (no window), against the reference, as a run reads them.

``--set key=value`` (a dotted key of the configuration file, the value as
JSON or a string) changes the configuration on both sides, to look for
the cause of a reading (the reference is float32 whatever it says).

Prints one JSON line a seed and reading with the numbers and the cell's
limits.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import generator, run  # noqa: E402
from h100_bench.reference import compare  # noqa: E402
from h100_bench.reference.model import make_params, no_tf32, param_groups  # noqa: E402
from h100_bench.reference.train import run_steps  # noqa: E402

_SEED_MASK = 2 ** 63 - 1


def train_control(cfg: dict, mix: dict, seed: int, dev) -> dict:
    """{reading: numbers}: ``fp8`` (the control) and ``half_batch``."""
    seed &= _SEED_MASK
    params = make_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    cycle = generator.train_cycle(mix, seed)
    base = (seed * 1_000_003) & _SEED_MASK
    first = generator.first_steps(cycle, mix["reference_steps"])[: mix["reference_steps"]]
    batches = [{k: torch.from_numpy(getattr(cycle[i], k)).to(dev)
                for k in ("waves", "wave_lens", "targets", "target_lens")} for i in first]
    groups = param_groups(cfg)

    def steps(precision="fp32", rows=None):
        gens = [torch.Generator(device=dev).manual_seed(base + j) for j in range(len(batches))]
        cut = [{k: v[:rows] for k, v in b.items()} for b in batches]
        return run_steps(cfg, params, cut, gens, precision)

    ref = steps()
    return {"fp8": compare.train_gaps(steps("fp8"), ref, groups),
            "half_batch": compare.train_gaps(steps(rows=mix["rows"] // 2), ref, groups)}


def program_readings(cfg: dict, mix: dict, seed: int, dev) -> dict:
    """{"program": numbers} of a sound run: the driver's set-up and first
    steps, then the reference, as ``run.py`` takes them."""
    driver = run.load_module(ROOT / "h100_bench" / "drivers" / f"{mix['driver']}.py")
    ctx = {"args": argparse.Namespace(seed=seed, seconds=0.0, trace=0), "cfg": cfg, "mix": mix,
           "device": dev, "chips": 1}
    loop = driver.Loop(ctx)
    gaps = driver.reference_gaps(loop, loop.warm())
    del loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"program": gaps}


def override(cfg: dict, setting: str) -> None:
    """``key.sub=value`` into ``cfg``."""
    key, value = setting.split("=", 1)
    *path, last = key.split(".")
    node = cfg
    for k in path:
        node = node[k]
    if last not in node:
        raise SystemExit(f"--set: the configuration has no {key!r}")
    try:
        node[last] = json.loads(value)
    except json.JSONDecodeError:
        node[last] = value


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
        override(cfg, setting)
    dev = torch.device(args.device)
    no_tf32()
    limits = compare.limits_for(args.workload)
    readings = program_readings if args.program else train_control
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
