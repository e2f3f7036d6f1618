"""Driver ``train_step``: the port's supervised train step
(``training/steps.py::make_train_step``, built as ``train.py`` builds it)
over a bucketed training mix.

Set-up: weights from the seed on the card, the step and its state, the
mix's cycle of batches in pinned host memory, then one step on a batch of
each bucket, in the cycle's order: the first steps of the state the window
goes on with, whose losses, first gradient norms and parameter change the
reference follows.  Every step copies its batch host -> device from pinned
memory and reseeds the step's generator from (seed, step) as the trainer
does; steps are dispatched ahead, and the loss is read every
``loss_every`` steps (``log_every_n_steps``).

``--trace 0`` measures the window: whole cycles of the mix, until
``--seconds`` have passed at a cycle's end (each seed's window holds the
same work); the unpadded audio of every step over the window's seconds,
the window closed by ``torch.cuda.synchronize()``.
``--trace 1`` times the step call's enqueue over one cycle, then profiles
the next cycle's steps.
"""

from __future__ import annotations

import gc
import json
import math
import time

import numpy as np
import torch

from h100_bench import counts, generator, outcome, port, trace
from h100_bench.reference import compare
from h100_bench.reference.model import make_params, no_tf32, param_groups
from h100_bench.reference.train import run_steps

_SEED_MASK = 2 ** 63 - 1


def _pinned(b: generator.TrainBatch, cuda: bool) -> dict:
    arrays = {"waves": b.waves, "wave_lens": b.wave_lens,
              "prev_samples": np.zeros(b.waves.shape[0], np.float32),
              "targets": b.targets, "target_lens": b.target_lens}
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).pin_memory() if cuda
                else torch.from_numpy(np.ascontiguousarray(v))) for k, v in arrays.items()}


def hand_bound_ms(b: dict, cfg: dict) -> float:
    """The roofline bound of K1-K6's calls in one step on ``b``: K6 and K1 on the waves, K2 (with its cell output) and K3
    on the BiLSTM's valid frames, K4 and K5 on the CTC's."""
    fe = cfg["frontend"]
    B, S = b["waves"].shape
    T, out = counts.output_frames(b["wave_lens"].numpy(), S, fe)
    Tp = (T + 1) // 2
    total = counts.k6(B, S, counts.k6_out_len(S, fe)) + counts.k1(B, T, fe)
    ctx = cfg.get("context")
    if ctx:
        steps = int(out.sum()) * 2
        total += counts.k2(steps, B, Tp, ctx["hidden"], 2) + counts.k3(steps, B, Tp,
                                                                       ctx["hidden"], 2)
    C, L = cfg["num_classes"], b["targets"].shape[1]
    small = (b["targets"].numel() + 3 * B) * 4
    total += counts.k4(int(out.sum()), C, 2 * L + 1, small)
    total += counts.k5(int(out.sum()), C, 2 * L + 1, small, B * Tp * C)
    return total


def valid_frames(b: dict, cfg: dict) -> list:
    """Each row's output frames (after the stride-2 stem)."""
    return counts.output_frames(b["wave_lens"].numpy(), b["waves"].shape[1],
                                cfg["frontend"])[1].tolist()


def _second_moments(opt_state, names: list) -> dict:
    """Each tensor's squared gradient norm from NovoGrad's state after its
    first step (fused: a vector in the parameters' order)."""
    v = opt_state.exp_avg_sq
    if isinstance(v, dict):
        return {k: float(v[k]) for k in names}
    return dict(zip(names, v.tolist()))


class Loop:
    """The step, its state and its feed."""

    def __init__(self, ctx: dict):
        args, cfg, mix = ctx["args"], ctx["cfg"], ctx["mix"]
        self.ctx, self.cfg, self.mix, self.dev = ctx, cfg, mix, ctx["device"]
        cuda = self.dev.type == "cuda"
        seed = args.seed & _SEED_MASK
        wgen = torch.Generator(device=self.dev).manual_seed(seed)
        self.params = make_params(cfg, wgen, self.dev)
        self.step_fn, self.state = port.train_step(cfg, self.params, self.dev)
        self.cycle = generator.train_cycle(mix, seed)
        self.host = [_pinned(b, cuda) for b in self.cycle]
        self.gen = torch.Generator(device=self.dev)
        self.base = (seed * 1_000_003) & _SEED_MASK
        self.step_no = 0
        self.pos = 0

    def one(self, idx: int):
        batch = {k: v.to(self.dev, non_blocking=True) for k, v in self.host[idx].items()}
        self.gen.manual_seed(self.base + self.step_no)
        self.state, met = self.step_fn(self.state, batch, self.gen)
        self.step_no += 1
        return met

    def warm(self) -> dict:
        """One step on a batch of each bucket (the first steps); returns
        what the reference compares: the first steps' losses, the first
        step's gradient norms, the parameters after the compared steps."""
        n_ref = self.mix["reference_steps"]
        warm = generator.first_steps(self.cycle, n_ref)
        names = list(self.state.params)
        losses, first, after, preds = [], None, None, None
        for j, idx in enumerate(warm):
            met = self.one(idx)
            if j < n_ref:
                losses.append(float(met["loss"]))
            if j == 0:
                first = _second_moments(self.state.opt_state, names)
                preds = met["preds"]
            if j == n_ref - 1:
                after = self.state.params
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return {"warm": warm[:n_ref], "losses": losses, "preds": preds,
                "grad_norms": {k: math.sqrt(v) for k, v in first.items()}, "after": after}

    def steps(self, n: int = None, seconds: float = None, spans: list = None) -> dict:
        """Steps from the cycle's current place: ``n`` of them, or whole
        cycles until ``seconds`` have passed at a cycle's end, so that every seed's window holds the same work; returns
        {"steps", "audio_s", "batches"}; ``spans`` gets each step call's
        host ms."""
        every = self.mix["loss_every"]
        k, audio, batches, cycles = 0, 0.0, [], []
        t0 = time.perf_counter()
        while True:
            idx = self.pos % len(self.cycle)
            t = time.perf_counter()
            met = self.one(idx)
            if spans is not None:
                spans.append(1e3 * (time.perf_counter() - t))
            self.pos += 1
            k += 1
            audio += self.cycle[idx].audio_s
            batches.append(idx)
            if n is not None and k >= n:
                break
            if self.step_no % every == 0:
                float(met["loss"])
            if seconds is not None and self.pos % len(self.cycle) == 0:
                float(met["loss"])
                cycles.append(time.perf_counter() - t0)
                if cycles[-1] >= seconds:
                    break
        return {"steps": k, "audio_s": audio, "batches": batches, "cycle_ends_s": cycles}

    def finish(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def measure(loop: Loop, ctx: dict) -> dict:
    """The timed window (``--trace 0``) or the traced stretch (``--trace
    1``) after set-up; returns the run's records."""
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
        done = loop.steps(n=len(loop.cycle), spans=spans)
        loop.finish()
        records["step_host_ms"] = spans

        def stretch(n):
            t0 = time.perf_counter()
            records["stretch"] = loop.steps(n=n)
            loop.finish()
            return time.perf_counter() - t0

        tr = trace.profiled(stretch, len(loop.cycle))
        batches = [loop.host[i] for i in records["stretch"]["batches"]]
        tr["flops"] = sum(counts.model_flops(loop.cfg, valid_frames(b, loop.cfg), True)
                          for b in batches)
        tr["hand_bound_ms"] = sum(hand_bound_ms(b, loop.cfg) for b in batches)
        records["trace"] = tr
        print(f"h100_bench: traced {tr['steps']} steps in {tr['window_s']:.3f} s "
              f"({tr['passes']} pass(es)); launches {tr['launches']}, kernel records "
              f"{tr['records']}", flush=True)
    records["failed"] = int(loop.state.nan_count) - nan0
    records["first"] = first
    return records


def reference_gaps(loop: Loop, first: dict) -> dict:
    """The reference's steps on the first steps' batches, draws and
    weights, against the program's (``compare.train_gaps``); the program's
    state freed first."""
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


def attempted(records: dict) -> int:
    """Steps the window (or the traced stretch) ran."""
    return records.get("steps", records.get("stretch", {}).get("steps", 0))


def run(ctx: dict) -> dict:
    loop = Loop(ctx)
    records = measure(loop, ctx)
    device = outcome.device_info(loop.dev, ctx["chips"], records.get("trace"))
    checks = compare.judged(reference_gaps(loop, records.pop("first")),
                            compare.limits_for(ctx["cell"]["name"]))
    return outcome.result(records, device, checks, attempted(records), records["failed"])
