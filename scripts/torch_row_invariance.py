#!/usr/bin/env python3
"""Does a row get the same bits alone as in a batch?  On the card, for the
port's default and SE encoders and for the SE's Dense layer.

    python3 scripts/torch_row_invariance.py

``StreamingTranscriber`` runs one window at a time and ``translate_long``
runs the same windows as the rows of one batch; their texts agree only
where every op gives a row the bits it gets alone (ROADMAP C13).  Prints
one JSON line per encoder (each window of a 90 s wave: how many module
outputs differ between its batch row and its one-row run, the first that
does, the log-probs' largest gap) and one line for the Dense layer's
variants at the SE's shapes (``F.linear``, a batched matmul, the port's
``Dense``: equal at 2-32 rows to the first row alone?).  Needs a GPU;
imports no JAX.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from lightning_asr_torch.data.audio import read_audio, wav_bytes  # noqa: E402
from lightning_asr_torch.inference.predict import plan_chunks  # noqa: E402
from lightning_asr_torch.models.layers import Dense  # noqa: E402


def windows_alone_and_batched(encoder: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        tr = cs.AsrTranslator(cs.serving_checkpoint(tmp, encoder=encoder), device="cuda")
    wave = (np.random.default_rng(6).standard_normal(int(cs.LONG_S * cs.SR)) * 0.1).astype(np.float32)
    wave16 = read_audio(wav_bytes(wave, cs.SR))[0][0]
    chunk, overlap = int(cs.CHUNK_S * cs.SR), int(cs.OVERLAP_S * cs.SR)
    windows = [wave16[s: s + chunk] for s, _, _ in plan_chunks(wave16.shape[0], chunk, overlap)]
    batch, lens = tr.pad_batch(windows, n_max=chunk)
    order, outs = [], {}

    def hook(name):
        def keep(module, args, out):
            if torch.is_tensor(out):
                outs.setdefault(name, []).append(out.detach().clone())
                if name not in order:
                    order.append(name)
        return keep

    handles = [m.register_forward_hook(hook(n)) for n, m in tr.model.named_modules() if n]
    dev = tr.device
    with torch.inference_mode():
        tr._forward(torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev))
        for k in range(len(windows)):
            tr._forward(torch.from_numpy(batch[k:k + 1]).to(dev), torch.from_numpy(lens[k:k + 1]).to(dev))
    for h in handles:
        h.remove()
    rows = []
    for k in range(len(windows)):
        differ = [n for n in order if not torch.equal(outs[n][0][k], outs[n][1 + k][0])]
        gap = (outs["decoder"][0][k].float() - outs["decoder"][1 + k][0].float()).abs().max().item()
        rows.append({"window": k, "modules_differ": len(differ),
                     "first": differ[0] if differ else None, "log_prob_max_abs": gap})
    return {"encoder": encoder, "batch": list(batch.shape), "modules": len(order), "windows": rows}


def dense_variants(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for o, i in ((64, 512), (512, 64), (32, 256), (256, 32)):
        dense = Dense(i, o).to(dev)
        with torch.no_grad():
            dense.weight.copy_(torch.randn(o, i, generator=gen, device=dev) / i ** 0.5)
        w = dense.weight.detach()
        x = torch.randn(32, i, generator=gen, device=dev)
        ops = {"F.linear": lambda t: F.linear(t, w),
               "bmm": lambda t: torch.bmm(t[:, None, :], w.t().expand(t.shape[0], -1, -1))[:, 0],
               "Dense": dense}
        with torch.no_grad():
            for name, op in ops.items():
                alone = op(x[:1])[0]
                out[f"{o}x{i} {name}"] = all(torch.equal(op(x[:b])[0], alone) for b in (2, 4, 8, 16, 32))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_row_invariance: needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for encoder in ("quartznet12_context", "quartznet12_context_se"):
        print(json.dumps(windows_alone_and_batched(encoder)), flush=True)
    print(json.dumps({"dense_row_invariant": dense_variants(torch.device("cuda", 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
