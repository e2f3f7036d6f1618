"""The benchmark of ``lightning_asr_torch`` on NVIDIA H100 cards.

    python h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in ``BENCHMARK.json``, the cell's configuration file,
its traffic mix (``h100_bench/traffic/<mix>.json``), the driver the mix
names (``h100_bench/drivers/<driver>.py``) and each metric's reader
(``h100_bench/metrics/<metric>.py``), all by name: nothing here knows a
cell, a configuration, a mix or a metric.  The driver builds the program's
entry from seeded weights, warms the cell's shapes (set-up), measures for
``--seconds`` (``--trace 0``) or profiles a steady stretch (``--trace 1``),
and checks what the timed path produced against the plain reference in
``h100_bench/reference/``.  The last line of standard output is the
result's JSON; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.

It exits with 3 and prints no result when the cell's cards are not there,
and with 4 when ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``lightning_asr_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lightning_asr_tpu")


def since_start() -> float:
    """Seconds from this process's start to now (from /proc where it
    exists, else from this module's import)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_START


def cache_env() -> None:
    """Build caches inside the checkout; transformers kept from JAX."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "h100_bench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "h100_bench" / "triton")


def load_module(path: Path):
    """A Python file by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"h100_bench_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, name: str) -> dict:
    """The cell, its configuration file, its mix and its driver, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = BENCH / "drivers" / f"{mix['driver']}.py"
    return {"cell": cell, "cfg": cfg, "mix": mix, "driver": driver}


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metrics of one kind: those whose ``workloads`` name it, or
    that name none."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(bench: dict, args, out: dict) -> dict:
    """The result's JSON from a driver's records: each of the cell's
    metrics by its reader; those with nothing to read left out."""
    values = {}
    for m in metrics_of(bench, args.workload, bool(args.trace)):
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(out["records"])
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    res = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
           "metrics": values, "device": out["device"]}
    if args.trace and out.get("breakdown"):
        res["breakdown"] = out["breakdown"]
    res["checks"] = out["checks"]
    return res


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, bench: dict, device, chips: int) -> dict:
    """The cell's driver run on ``device`` (the CPU tests' way in, past the
    look for a card)."""
    found = cell_of(bench, args.workload)
    ctx = {"args": args, "cell": found["cell"], "cfg": found["cfg"], "mix": found["mix"],
           "device": device, "chips": chips, "since_start": since_start,
           "tmp": Path(os.environ.get("TMPDIR") or "/tmp")}
    return load_module(found["driver"]).run(ctx)


def main(argv=None) -> int:
    cache_env()
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = cell_of(bench, args.workload)["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    out = execute(args, bench, torch.device("cuda", 0), chips)
    loaded = forbidden_loaded()
    if loaded:
        print(f"h100_bench: loaded in the measuring process: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    res = result_line(bench, args, out)
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
