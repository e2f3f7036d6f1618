"""Driver ``conformer_train_step``: ``train_step``'s loop (the port's train
step built as ``train.py`` builds it, the mix's batches in pinned memory,
one warm step a bucket, the window of whole cycles or the profiled
stretch) on a Conformer-CTC configuration: its weights and the reference
it is checked against come from ``reference/conformer.py``, its FLOPs and
the hand kernels' bounds from ``counts_conformer.py``.

Besides the records ``train_step`` keeps, a run prints on a line of its
own the routes the step's calls took (``train_step.graphs.counts``) and
the attention's backend counter (``conformer.attention.backend`` of
``training/profiler.py``), which the per-layer metrics do not read.
"""

from __future__ import annotations

import gc
import json
import time

import torch

from h100_bench import counts_conformer, generator, outcome, port, trace
from h100_bench.drivers import train_step as base
from h100_bench.reference import compare
from h100_bench.reference.conformer import make_params, param_groups, run_steps
from h100_bench.reference.model import no_tf32

COUNTER = "conformer.attention.backend"


class Loop(base.Loop):
    """``train_step.Loop`` with the Conformer's weights."""

    def __init__(self, ctx: dict):
        args, cfg, mix = ctx["args"], ctx["cfg"], ctx["mix"]
        self.ctx, self.cfg, self.mix, self.dev = ctx, cfg, mix, ctx["device"]
        cuda = self.dev.type == "cuda"
        seed = args.seed & base._SEED_MASK
        wgen = torch.Generator(device=self.dev).manual_seed(seed)
        self.params = make_params(cfg, wgen, self.dev)
        self.step_fn, self.state = port.train_step(cfg, self.params, self.dev)
        self.cycle = generator.train_cycle(mix, seed)
        self.host = [base._pinned(b, cuda) for b in self.cycle]
        self.gen = torch.Generator(device=self.dev)
        self.base = (seed * 1_000_003) & base._SEED_MASK
        self.step_no = 0
        self.pos = 0


def valid_frames(b: dict, cfg: dict) -> list:
    return counts_conformer.output_frames(b["wave_lens"].numpy(), b["waves"].shape[1],
                                          cfg["frontend"])[1].tolist()


def routes(step) -> dict:
    """The step's routes (``train_step.graphs.counts``) and the attention's
    backend counter, each empty where the program has none."""
    from lightning_asr_torch.training import profiler
    graphs = getattr(step, "graphs", None)
    return {"train_step.graphs.counts": dict(getattr(graphs, "counts", {})),
            COUNTER: dict(getattr(profiler, "COUNTERS", {}).get(COUNTER, {}))}


def measure(loop: Loop, ctx: dict) -> dict:
    """``train_step.measure`` with this configuration's FLOPs and bounds."""
    args = ctx["args"]
    first = loop.warm()
    records = {"setup_s": ctx["since_start"]()}
    nan0 = int(loop.state.nan_count)
    if not args.trace:
        t0 = time.perf_counter()
        done = loop.steps(seconds=args.seconds)
        loop.finish()
        records.update(window_s=time.perf_counter() - t0, audio_s=done["audio_s"],
                       steps=done["steps"])
        print(f"h100_bench: {done['steps']} steps, cycles ended at "
              f"{[round(t, 3) for t in done['cycle_ends_s']]} s", flush=True)
    else:
        spans = []
        loop.steps(n=len(loop.cycle), spans=spans)
        loop.finish()
        records["step_host_ms"] = spans

        def stretch(n):
            t0 = time.perf_counter()
            records["stretch"] = loop.steps(n=n)
            loop.finish()
            return time.perf_counter() - t0

        tr = trace.profiled(stretch, len(loop.cycle))
        batches = [loop.host[i] for i in records["stretch"]["batches"]]
        tr["flops"] = sum(counts_conformer.model_flops(loop.cfg, valid_frames(b, loop.cfg), True)
                          for b in batches)
        tr["hand_bound_ms"] = sum(counts_conformer.hand_bound_ms(
            tuple(b["waves"].shape), b["wave_lens"].numpy(), b["targets"].shape[1], loop.cfg)
            for b in batches)
        records["trace"] = tr
        print(f"h100_bench: traced {tr['steps']} steps in {tr['window_s']:.3f} s "
              f"({tr['passes']} pass(es)); launches {tr['launches']}, kernel records "
              f"{tr['records']}", flush=True)
    records["failed"] = int(loop.state.nan_count) - nan0
    records["first"] = first
    print("h100_bench: routes " + json.dumps(routes(loop.step_fn)), flush=True)
    return records


def reference_gaps(loop: Loop, first: dict) -> dict:
    """``train_step.reference_gaps`` against ``reference/conformer.py``."""
    cfg, dev = loop.cfg, loop.dev
    p0 = loop.params
    names = list(first["after"])
    prog = {"losses": first["losses"], "grad_norms": first["grad_norms"], "preds": first["preds"],
            "change": {k: float((first["after"][k] - p0[k]).norm()) for k in names}}
    batches = []
    for idx in first["warm"]:
        b = loop.cycle[idx]
        batches.append({"waves": torch.from_numpy(b.waves).to(dev),
                        "wave_lens": torch.from_numpy(b.wave_lens).to(dev),
                        "targets": torch.from_numpy(b.targets).to(dev),
                        "target_lens": torch.from_numpy(b.target_lens).to(dev)})
    gens = [torch.Generator(device=dev).manual_seed(loop.base + j) for j in range(len(batches))]
    loop.state = loop.step_fn = first["after"] = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    ref = run_steps(cfg, p0, batches, gens)
    gaps = compare.train_gaps(prog, ref, param_groups(cfg))
    print(f"h100_bench: reference losses {ref['losses']} program {prog['losses']}; "
          f"numbers {json.dumps(gaps)}", flush=True)
    ref.clear()
    return gaps


def run(ctx: dict) -> dict:
    loop = Loop(ctx)
    records = measure(loop, ctx)
    device = outcome.device_info(loop.dev, ctx["chips"], records.get("trace"))
    checks = compare.judged(reference_gaps(loop, records.pop("first")),
                            compare.limits_for(ctx["cell"]["name"]))
    return outcome.result(records, device, checks, base.attempted(records), records["failed"])
