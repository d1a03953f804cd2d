"""VMAF through ffmpeg's libvmaf, a subprocess (counterpart of
``fcvsr_tpu.metrics.vmaf``).

The reference runs ``ffmpeg -filter_complex libvmaf`` over PNG frame
folders (CVSR_train/test_LD_freqCVSR.py:118-133).  Without ffmpeg on the
PATH each wrapper raises a clear error; with it, ``calculate_vmaf`` reads
libvmaf's JSON log and ``calculate_vmaf_reference`` repeats the reference's
three commands and its stdout scrape.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile

__all__ = ["ffmpeg_available", "calculate_vmaf", "calculate_vmaf_reference"]


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def calculate_vmaf(dist_dir: str, ref_dir: str, width: int, height: int,
                   fps: int = 25, pattern: str = "%08d.png",
                   _run=subprocess.run) -> float:
    """Mean VMAF of the PNG sequence in ``dist_dir`` against ``ref_dir``.

    ``_run`` is injectable, so the argv and the JSON log's parsing are
    testable without ffmpeg.
    """
    if _run is subprocess.run and not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg with libvmaf is required for VMAF but was not found on "
            "PATH; install ffmpeg or skip the VMAF metric.")
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "vmaf.json")
        cmd = [
            "ffmpeg", "-nostdin", "-r", str(fps),
            "-i", os.path.join(dist_dir, pattern),
            "-r", str(fps), "-i", os.path.join(ref_dir, pattern),
            "-filter_complex",
            f"libvmaf=log_fmt=json:log_path={log}",
            "-f", "null", "-",
        ]
        _run(cmd, check=True, capture_output=True)
        with open(log) as f:
            data = json.load(f)
        return float(data["pooled_metrics"]["vmaf"]["mean"])


def calculate_vmaf_reference(dist_dir: str, ref_dir: str, out_dist_vid: str,
                             out_ref_vid: str, framerate: int = 10,
                             pattern: str = "%05d.png",
                             _run=subprocess.run,
                             _popen=subprocess.Popen) -> float:
    """Reference-exact VMAF: pack both PNG dirs to .mkv, then libvmaf.

    The reference's commands (CVSR_train/test_LD_freqCVSR.py:118-133):
    two ``ffmpeg -loglevel quiet -y -framerate 10 -i %05d.png -c:v copy``
    packing passes run with ``cwd`` set to each frame directory, then
    ``ffmpeg -loglevel info -i dist -i ref -filter_complex libvmaf -f null -``
    with the score scraped from the 8 characters after ``'VMAF score:'``
    in the merged stdout/stderr stream (the reference parses stdout with
    stderr redirected into it).  ``_run``/``_popen`` are injectable for
    argv-level testing without ffmpeg.
    """
    if _run is subprocess.run and not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg with libvmaf is required for VMAF but was not found on "
            "PATH; install ffmpeg or skip the VMAF metric.")
    for src_dir, out_vid in ((dist_dir, out_dist_vid),
                             (ref_dir, out_ref_vid)):
        _run(["ffmpeg", "-loglevel", "quiet", "-y", "-framerate",
              str(framerate), "-i", pattern, "-c:v", "copy", out_vid],
             cwd=src_dir)
    proc = _popen(["ffmpeg", "-loglevel", "info", "-i", out_dist_vid,
                   "-i", out_ref_vid, "-filter_complex", "libvmaf",
                   "-f", "null", "-"],
                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    stdout, _ = proc.communicate()
    stdout = stdout.decode()
    marker = "VMAF score:"
    if marker not in stdout:
        raise RuntimeError("libvmaf produced no 'VMAF score:' line")
    s = stdout.index(marker) + len(marker)
    return float(stdout[s:s + 8])
