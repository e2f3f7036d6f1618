#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel from lightning_asr_torch/csrc (time, and
     whether it came from the cache);
  3. K1, the fused log-mel kernel, at the serving shapes (8 rows of 16 s,
     1601 frames) against its plain PyTorch version on the card, with its
     time, the plain version's and torch.stft's as a yardstick;
  4. K2, the BiLSTM recurrence kernel (B=8, T=801, C=256, H=40, ragged
     lengths, both directions), the same way, with cuDNN's packed LSTM as
     the yardstick;
  5. serving: a full-width quartznet12_context checkpoint made from seeded
     weights (bf16 convs, "default" frontend tier) is loaded by
     AsrTranslator on the card and served over HTTP with dynamic batching;
     8 concurrent WAV requests of 2-16 s must answer 200 as one device
     batch, a wrong form field 400, both kernels must launch; the served
     batch's log-probs on the card must agree with the same translator on
     the CPU, and the served texts must be the card's transcription of it;
  6. profile: one steady serving batch's host-clock latency and, from
     torch.profiler, its device time by kernel group;
  7. a {"kernels": [...]} line: per kernel its launches while serving, its
     error against the plain version, its time, the plain version's, the
     library yardstick's, and the least time the card could take;
  8. {"ok": true, "device": {...}} as the last line.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import http.client
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lightning_asr_torch.data.audio import read_audio, wav_bytes
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.inference.server import make_stdlib_server
from lightning_asr_torch.models.layers import MaskedBatchNorm
from lightning_asr_torch.models.quartznet import build_model, reset_parameters
from lightning_asr_torch.ops import kernel_build
from lightning_asr_torch.ops.frontend import (MelFrontendConfig, _extend_signal, _preemphasis,
                                              mel_filterbank, pad_for_frames)
from lightning_asr_torch.ops.frontend_kernels import mel_from_extended, mel_from_extended_plain
from lightning_asr_torch.ops.lstm_kernels import lstm_recurrence, lstm_recurrence_plain
from lightning_asr_torch.training.checkpoint import save_checkpoint

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

# One bf16 rounding flip of one power term moves a mel value by at most
# 10·log10(1 + 2^-8) = 0.017 dB; the narrowest mel filters span two bins.
K1_TOL_DB = 2 * 10 * np.log10(1 + 2.0 ** -8)
# float32 recurrence: dot sums in another order and the card's expf/tanhf,
# carried through up to 801 dependent steps with |h| < 1
K2_TOL = 1e-4
# bf16 model, card vs CPU, over the valid frames of the served batch: cuDNN
# and oneDNN round each conv's bf16 output from different fp32 sums (2^-8
# relative), through 16 blocks.  The same model in bf16 against float32 on
# the CPU, on the same batch, differs by max 0.23, mean 0.039, argmax
# agreement 0.980; the card's bf16 against the CPU's differs by mean 0.032
# on an H100, so the two bf16 roundings are largely independent.
SERVE_TOL_MAX, SERVE_TOL_MEAN, SERVE_MIN_ARGMAX = 0.5, 0.05, 0.9
# The tighter check: the card's bf16 log-probs may lie no further from the
# float32 model's (on the CPU) than the CPU's bf16 log-probs do, by mean
# over valid frames, within this factor.
SERVE_BF16_GAP_RATIO = 1.25
# With these seeded weights nearly every frame's argmax is one class, so a
# text hangs on a few near-tied frames: bf16 against float32 on the CPU
# gives a character error rate of 0.355 on the served batch.
SERVE_MAX_CER = 0.5
# transcribe_batch calls timed on the host clock, and calls profiled
PROFILE_ITERS = (10, 3)

SR = 16000
LABELS = [" ", "'"] + [chr(ord("a") + i) for i in range(26)]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call on the card, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, kind: str):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_k1(dev) -> dict:
    cfg = MelFrontendConfig(precision="default")
    rng = np.random.default_rng(0)
    B, S = 8, 16 * SR
    waves = torch.from_numpy((rng.standard_normal((B, S)) * 0.1).astype(np.float32)).to(dev)
    lens = torch.tensor([S, S - 1, 15 * SR, 12 * SR + 7, 9 * SR, 6 * SR, 3 * SR, 2 * SR + 289],
                        dtype=torch.int32, device=dev)
    T = (S + 2 * cfg.pad) // cfg.hop_length + 1
    pre = _preemphasis(waves, None, cfg.preemph)
    q = pad_for_frames(_extend_signal(pre, lens, cfg), cfg, T).contiguous()

    mel_from_extended.launches = 0
    got = mel_from_extended(q, cfg, T)
    want = mel_from_extended_plain(q, cfg, T)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (B, T, cfg.n_mels) and bool(torch.isfinite(got).all()), "K1 output shape/finite")
    check(err <= K1_TOL_DB, f"K1 max |kernel - plain| = {err} dB > {K1_TOL_DB}")

    ms = cuda_ms(lambda: mel_from_extended(q, cfg, T), 20)
    plain_ms = cuda_ms(lambda: mel_from_extended_plain(q, cfg, T), 10)
    # yardstick: torch.stft + power + filterbank matmul + dB on the
    # zero-padded preemphasized rows (reflect padding by stft itself)
    x = torch.nn.functional.pad(pre, (cfg.pad, cfg.pad))
    window = torch.hann_window(cfg.win_length, periodic=True, device=dev)
    fb = torch.from_numpy(mel_filterbank(cfg)).to(dev)

    def library():
        spec = torch.stft(x, cfg.n_fft, cfg.hop_length, cfg.win_length, window, center=True,
                          pad_mode="reflect", return_complex=True)
        mel = torch.matmul(spec.abs().pow(2).transpose(1, 2), fb)
        return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))

    check(library().shape == got.shape, "stft yardstick shape")
    library_ms = cuda_ms(library, 20)
    # bytes: the samples the frames cover, the unpadded DFT and mel tables
    # in bf16, the log-mels out
    F = cfg.n_freqs
    span = min(q.shape[1], (T - 1) * cfg.hop_length + cfg.n_fft)
    nbytes = B * span * 4 + (2 * F * cfg.n_fft + F * cfg.n_mels) * 2 + got.numel() * 4
    flops = B * T * (2 * 2 * F * cfg.n_fft + 3 * F + 2 * F * cfg.n_mels)
    bound_ms, bound_by = bound(nbytes, flops, "bf16")
    res = {"name": "log_mel (K1)", "route": "cuda", "source": "lightning_asr_torch/csrc/mel.cu",
           "replaces": "lightning_asr_tpu/ops/frontend_pallas.py:194",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    print(json.dumps({"phase": "K1", "shape": [B, S, T], "tol_db": K1_TOL_DB, "kernel_ms": ms,
                      "phase_launches": mel_from_extended.launches, **res}), flush=True)
    return res


def phase_k2(dev) -> dict:
    rng = np.random.default_rng(1)
    B, T, C, H, D = 8, 801, 256, 40, 2
    s = 1.0 / np.sqrt(H)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(dev)
    w_ih = torch.from_numpy(rng.uniform(-s, s, (D, 4 * H, C)).astype(np.float32)).to(dev)
    w_hh = torch.from_numpy(rng.uniform(-s, s, (D, 4 * H, H)).astype(np.float32)).to(dev)
    b_ih = torch.from_numpy(rng.uniform(-s, s, (D, 4 * H)).astype(np.float32)).to(dev)
    b_hh = torch.from_numpy(rng.uniform(-s, s, (D, 4 * H)).astype(np.float32)).to(dev)
    lens_np = np.array([T, 1, 750, 640, 512, 401, 233, 97], np.int32)
    lens = torch.from_numpy(lens_np).to(dev)
    xproj = (torch.matmul(x, w_ih.reshape(D * 4 * H, C).t()) + b_ih.reshape(-1)
             + b_hh.reshape(-1)).reshape(B, T, D, 4 * H).contiguous()

    lstm_recurrence.launches = 0
    got = lstm_recurrence(xproj, lens, w_hh)
    want = lstm_recurrence_plain(xproj, lens, w_hh)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (B, T, D * H) and bool(torch.isfinite(got).all()), "K2 output shape/finite")
    pad_zero = all(bool((got[b, n:] == 0).all()) for b, n in enumerate(lens_np))
    check(pad_zero, "K2 pad frames are not exactly zero")
    check(err <= K2_TOL, f"K2 max |kernel - plain| = {err} > {K2_TOL}")

    ms = cuda_ms(lambda: lstm_recurrence(xproj, lens, w_hh), 20)
    plain_ms = cuda_ms(lambda: lstm_recurrence_plain(xproj, lens, w_hh), 2, warmup=1)
    # yardstick: cuDNN's bidirectional LSTM over the packed sequence, input
    # projection included (the port never calls it)
    ref = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(ref, f"weight_ih_l0{sfx}").copy_(w_ih[d])
            getattr(ref, f"weight_hh_l0{sfx}").copy_(w_hh[d])
            getattr(ref, f"bias_ih_l0{sfx}").copy_(b_ih[d])
            getattr(ref, f"bias_hh_l0{sfx}").copy_(b_hh[d])
    lens_cpu = torch.from_numpy(lens_np.astype(np.int64))

    @torch.no_grad()
    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens_cpu, batch_first=True,
                                                         enforce_sorted=False)
        out, _ = ref(packed)
        return torch.nn.utils.rnn.pad_packed_sequence(out, batch_first=True, total_length=T)[0]

    lib_err = (library() - got).abs().max().item()
    library_ms = cuda_ms(library, 10)
    G = 4 * H
    steps = int(lens_np.sum()) * D
    # bytes: the projections of the valid frames only (the kernel reads no
    # pad frame), W_hh and the lengths in, the whole of h out
    nbytes = steps * G * 4 + w_hh.numel() * 4 + lens.numel() * 4 + got.numel() * 4
    flops = steps * (2 * G * H + 2 * G + 5 * H)
    bound_ms, bound_by = bound(nbytes, flops, "fp32")
    res = {"name": "lstm_recurrence (K2)", "route": "cuda", "source": "lightning_asr_torch/csrc/lstm.cu",
           "replaces": "lightning_asr_tpu/ops/lstm_pallas.py:62",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    print(json.dumps({"phase": "K2", "shape": [B, T, C, H, D], "tol": K2_TOL, "kernel_ms": ms,
                      "cudnn_max_abs_diff": lib_err, "sequential_steps": int(lens_np.max()),
                      "phase_launches": lstm_recurrence.launches, **res}), flush=True)
    return res


def with_teeth(model, gen: torch.Generator, decoder_scale: float = 50.0) -> None:
    """Non-trivial BatchNorm statistics and affine terms and a scaled-up
    decoder: freshly initialised weights give nearly uniform log-probs.

    The decoder's input is non-negative (ReLU) with a large common mean, so
    one class would win every frame; its bias is set to cancel that mean on
    a calibration batch, and the head is then scaled, so that the greedy
    argmax varies from frame to frame."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.5)
                m.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
        seen = {}
        hook = model.decoder.register_forward_pre_hook(lambda mod, args: seen.setdefault("x", args[0]))
        feats = torch.randn((2, 200, 64), generator=gen)
        model.eval()(feats, torch.ones(2))
        hook.remove()
        mean_in = seen["x"].float().mean(dim=(0, 2))
        model.decoder.bias.copy_(-(model.decoder.weight[:, :, 0] @ mean_in))
        model.decoder.weight.mul_(decoder_scale)
        model.decoder.bias.mul_(decoder_scale)


def _edits(a: str, b: str) -> int:
    """Levenshtein distance between two strings."""
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _post(port: int, payload: bytes, field: str = "audio"):
    boundary = "chipsmokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
            f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    body += payload + f"\r\n--{boundary}--\r\n".encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/", body=body,
                     headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace"), time.perf_counter() - t0
    finally:
        conn.close()


def phase_serving(dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    model = build_model(len(LABELS) + 1, "quartznet12_context", mask=True, dtype=torch.bfloat16)
    reset_parameters(model, gen)
    with_teeth(model, gen)
    hparams = {"labels": LABELS, "use_cer": False, "encoder": "quartznet12_context", "in_c": 64,
               "mask": True, "compute_dtype": "bfloat16",
               "frontend": dict(MelFrontendConfig(precision="default").__dict__),
               "normalize": True}
    rng = np.random.default_rng(2)
    seconds = [2.0, 3.5, 5.0, 7.0, 9.0, 11.0, 13.5, 16.0]
    waves = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    blobs = [wav_bytes(w, SR) for w in waves]

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, model.state_dict(), hparams)
        t0 = time.perf_counter()
        translator = AsrTranslator(ckpt, device="cuda")
        load_s = time.perf_counter() - t0
        cpu = AsrTranslator(ckpt, device="cpu")
        cpu32 = AsrTranslator(save_checkpoint(f"{tmp}/fp32", model.state_dict(),
                                              {**hparams, "compute_dtype": "float32"}), device="cpu")
    check(translator.device.type == "cuda", "translator is not on the card")

    # the window outlasts the burst's arrival, and the batcher dispatches as
    # soon as it holds max_batch requests: the 8 requests form one device
    # batch, the one checked below
    server = make_stdlib_server(translator, port=0, batching=True, max_batch=8, max_wait_ms=2000.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        mel_from_extended.launches = 0
        lstm_recurrence.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(blobs) + 1) as pool:
            futs = [pool.submit(_post, port, b) for b in blobs]
            bad = pool.submit(_post, port, blobs[0], "file")
            answers = [f.result() for f in futs]
            bad_status = bad.result()[0]
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        launches = {"mel": mel_from_extended.launches, "lstm": lstm_recurrence.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    statuses = [a[0] for a in answers]
    check(all(s == 200 for s in statuses), f"request statuses {statuses}")
    check(bad_status == 400, f"wrong form field answered {bad_status}, not 400")
    check(launches == {"mel": 1, "lstm": 1},
          f"kernel launches while serving {launches}: the burst did not run as one device batch")

    # the served batch, as the server decoded it (16-bit PCM), on the card
    # against the same translator on the CPU, over each row's valid frames
    served = [read_audio(b, mono=True)[0][0] for b in blobs]
    batch, lens = translator.pad_batch(served)
    check(batch.shape == (8, 16 * SR), f"served batch shape {batch.shape}")
    lp, out_lens = translator._forward(torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev))
    lp_cpu, out_lens_cpu = cpu._forward(torch.from_numpy(batch), torch.from_numpy(lens))
    lp_fp32 = cpu32._forward(torch.from_numpy(batch), torch.from_numpy(lens))[0].numpy()
    lp, lp_cpu = lp.float().cpu().numpy(), lp_cpu.float().numpy()
    out_lens, out_lens_cpu = out_lens.cpu().numpy(), out_lens_cpu.numpy()
    check(bool(np.isfinite(lp).all()) and lp.shape == lp_cpu.shape, "serving log-probs shape/finite")
    check(np.array_equal(out_lens, out_lens_cpu), "out_lens differ card vs CPU")
    valid = np.arange(lp.shape[1])[None, :] < out_lens_cpu[:, None]
    class_std = float(np.mean(np.std(lp_cpu[valid], axis=-1)))
    err = np.abs(lp - lp_cpu)[valid]
    agree = float(np.mean(lp.argmax(-1)[valid] == lp_cpu.argmax(-1)[valid]))
    check(class_std >= 0.5, f"log-prob class std {class_std} < 0.5: weights without teeth")
    check(err.max() <= SERVE_TOL_MAX and err.mean() <= SERVE_TOL_MEAN,
          f"card vs CPU log-probs: max {err.max()}, mean {err.mean()}")
    check(agree >= SERVE_MIN_ARGMAX, f"greedy argmax agreement {agree}")
    gap_card = float(np.abs(lp - lp_fp32)[valid].mean())
    gap_cpu = float(np.abs(lp_cpu - lp_fp32)[valid].mean())
    check(gap_card <= SERVE_BF16_GAP_RATIO * gap_cpu,
          f"card bf16 vs float32: mean {gap_card}, CPU bf16 vs float32: mean {gap_cpu}")

    # the served texts are the card's transcription of that batch; against
    # the CPU's, by character error rate
    texts = [a[1] for a in answers]
    card_texts = translator.transcribe_batch(served)
    cpu_texts = cpu.transcribe_batch(served)
    check(texts == card_texts, f"served texts {texts} differ from the card's {card_texts}")
    cer = sum(_edits(a, b) for a, b in zip(card_texts, cpu_texts)) / max(1, sum(map(len, cpu_texts)))
    check(cer <= SERVE_MAX_CER, f"card vs CPU texts: character error rate {cer}")
    res = {"phase": "serving", "requests": len(blobs), "seconds": seconds, "statuses": statuses,
           "wrong_field_status": bad_status, "launches": launches, "load_s": load_s,
           "burst_s": burst_s, "latency_s": [a[2] for a in answers],
           "texts_chars": [len(t) for t in texts], "class_std": class_std,
           "card_vs_cpu_max_abs": float(err.max()), "card_vs_cpu_mean_abs": float(err.mean()),
           "argmax_agreement": agree, "card_bf16_vs_fp32_mean_abs": gap_card,
           "cpu_bf16_vs_fp32_mean_abs": gap_cpu, "card_vs_cpu_cer": cer,
           "texts_equal_cpu": sum(a == b for a, b in zip(card_texts, cpu_texts)),
           "batch_shape": list(batch.shape)}
    print(json.dumps(res), flush=True)
    return res, translator, served


def _category(name: str) -> str:
    low = name.lower()
    if "log_mel_kernel" in low:
        return "K1 log_mel"
    if "lstm_fwd_kernel" in low:
        return "K2 lstm"
    if "memcpy" in low:
        return "copy"
    if any(s in low for s in ("conv", "fprop", "cudnn", "implicit")):
        return "conv"
    if "gemm" in low or "cutlass" in low:
        return "gemm"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def phase_profile(translator: AsrTranslator, waves) -> dict:
    """Where one steady serving batch's time goes: the host-clock latency of
    transcribe_batch over PROFILE_ITERS[0] batches after warm-up, and with
    torch.profiler the device time of each kernel per batch over
    PROFILE_ITERS[1] batches, grouped; the device's busy share is that
    device time over the unprofiled median latency (the profiler slows the
    host side)."""
    from torch.profiler import ProfilerActivity, profile

    iters, prof_iters = PROFILE_ITERS
    for _ in range(2):
        translator.transcribe_batch(waves)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        translator.transcribe_batch(waves)
        lat.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_iters):
            translator.transcribe_batch(waves)
        torch.cuda.synchronize()

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3 / prof_iters
    check(bool(kernels), "torch.profiler recorded no device time")
    by_cat = {}
    for name, ms in kernels.items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + ms
    device_ms = sum(kernels.values())
    median_ms = 1e3 * statistics.median(lat)
    res = {"phase": "profile", "batch": len(waves), "audio_s_per_batch": sum(len(w) for w in waves) / SR,
           "steady_latency_ms": {"median": median_ms, "min": 1e3 * min(lat), "max": 1e3 * max(lat),
                                 "n": iters},
           "device_ms_per_batch": device_ms, "device_busy_share": device_ms / median_ms,
           "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
           "top_kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])}
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    info = kernel_build.build_all()
    ptxas = [line.strip() for out in info["ptxas"].values() for line in out.splitlines()
             if "registers" in line or "Compiling entry" in line]
    print(json.dumps({"phase": "build", "seconds": info["seconds"], "cached": info["cached"],
                      "ptxas": ptxas}), flush=True)

    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    serving, translator, served = phase_serving(dev)
    phase_profile(translator, served)
    k1["launches"] = serving["launches"]["mel"]
    k2["launches"] = serving["launches"]["lstm"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in (k1, k2)]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
