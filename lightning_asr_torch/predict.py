"""Offline inference and evaluation CLI, the port's counterpart of the
repository's ``predict.py``: transcribe one wav (whole, by overlapped
windows with ``--long``, or as a simulated live stream with ``--stream``),
or evaluate a manifest, greedy or by beam search (``--device_beam``: the
LM-free search on the device; ``--lm`` / ``--hotword``: the native search
with an ARPA LM and hot words), with a per-utterance CSV and confidence
scores:

    python -m lightning_asr_torch.predict --model <ckpt> --audio a.wav
    python -m lightning_asr_torch.predict --model <ckpt> --manifest dev.json \\
        --lm lm.arpa --hotword word:3 --csv report.csv --confidence [--device cpu]

It runs on the card unless ``--device cpu`` asks for the CPU, and raises
without one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .data.audio import read_audio
from .decoding.beam_search import BeamSearchDecoderWithLM
from .decoding.device_beam import DeviceBeamSearchDecoder
from .inference.predict import AsrTranslator
from .inference.streaming import StreamingTranscriber


def main(argv=None) -> dict:
    """Run as the flags say; returns what was printed: {"audio": the
    transcript, "manifest": the evaluation}, each where asked."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, help="port checkpoint directory")
    ap.add_argument("--audio", help="single wav to transcribe")
    ap.add_argument("--manifest", help="JSONL manifest to evaluate")
    ap.add_argument("--lang", default="en", choices=["en", "cn"])
    ap.add_argument("--lm", help="ARPA LM path (enables the native beam search)")
    ap.add_argument("--device_beam", action="store_true",
                    help="LM-free beam search on the device instead of greedy")
    ap.add_argument("--long", action="store_true",
                    help="transcribe long audio (> 40 s) by overlapped windows")
    ap.add_argument("--stream", action="store_true",
                    help="simulate live streaming: feed the wav in --stream_block_seconds "
                         "blocks through StreamingTranscriber, printing each partial")
    ap.add_argument("--stream_block_seconds", type=float, default=1.0)
    ap.add_argument("--chunk_seconds", type=float, default=20.0)
    ap.add_argument("--overlap_seconds", type=float, default=2.0)
    ap.add_argument("--beam_width", type=int, default=40)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--num_cpus", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--hotword", action="append", default=[], metavar="WORD[:BOOST]",
                    help="bias decoding toward WORD (repeatable; default boost 4.0; "
                         "runs the native beam search)")
    ap.add_argument("--csv", help="per-utterance WER/confidence CSV output")
    ap.add_argument("--confidence", action="store_true",
                    help="also report CTC confidence scores")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--conv-kernel", choices=["sepconv", "dw_wgrad"], default=None,
                    help="run the blocks' separable convs through the fused kernels "
                         "(default: the F.conv1d pair)")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    if not args.audio and not args.manifest:
        ap.error("provide --audio and/or --manifest")

    translator = AsrTranslator(args.model, lang=args.lang, return_confidence=args.confidence,
                               device=args.device, conv_kernel=args.conv_kernel)
    hotwords = {}
    for spec in args.hotword:
        word, _, boost = spec.partition(":")
        hotwords[word] = float(boost) if boost else 4.0
    if args.lm or hotwords:
        translator.beam_decoder = BeamSearchDecoderWithLM(
            translator.vocab.labels, beam_width=args.beam_width, alpha=args.alpha,
            beta=args.beta, lm_path=args.lm or None, num_cpus=args.num_cpus, hotwords=hotwords)
    elif args.device_beam:
        translator.beam_decoder = DeviceBeamSearchDecoder(
            translator.vocab.labels, beam_width=args.beam_width, device=translator.device)

    result = {}
    if args.audio:
        if args.stream:
            samples, sr = read_audio(args.audio, mono=True)
            st = StreamingTranscriber(translator, chunk_seconds=min(args.chunk_seconds, 8.0),
                                      overlap_seconds=min(args.overlap_seconds, 1.0))
            block = int(args.stream_block_seconds * sr)
            wave, last = np.asarray(samples[0]), ""
            for lo in range(0, wave.shape[0], block):
                part = st.feed(wave[lo: lo + block])
                if part != last:
                    print(f"[{(lo + block) / sr:6.1f}s] {part}", flush=True)
                    last = part
            result["audio"] = st.finish()
        elif args.long:
            result["audio"] = translator.translate_long(
                args.audio, chunk_seconds=args.chunk_seconds, overlap_seconds=args.overlap_seconds)
        else:
            result["audio"] = translator.translate(args.audio)
        print(result["audio"], flush=True)
    if args.manifest:
        result["manifest"] = translator.evaluate_manifest(
            args.manifest, batch_size=args.batch_size, csv_path=args.csv)
        print(result["manifest"], flush=True)
    return result


if __name__ == "__main__":
    main()
