"""Unpadded audio-seconds of every train step the window completed (the
global batch's on a data-parallel world), over the window's seconds."""


def read(rec: dict):
    if not rec.get("steps"):
        return None
    return rec["audio_s"] / rec["window_s"]
