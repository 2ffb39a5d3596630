"""Timing the port's kernels on the card, shared by ``chip_smoke.py`` and
the breakdown tools (``kernels/mips_topk/breakdown.py``,
``kernels/hamming_topk/breakdown.py``, ``kernels/lsh_hash/breakdown.py``):

- ``time_ms``    median CUDA-event time of a call;
- ``kernel_ms``  each port kernel's device-only time per call, from
                 ``torch.profiler``;
- ``device_ms``  the device time of everything a call launches;
- ``card``       the card's name and power limit, as nvidia-smi prints
                 them;
- ``instrumented_source``, ``build_variants``  a breakdown's copies of a
                 kernel source, each with named parts switched off, one
                 ``nvcc`` per copy, all started together.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
from typing import Dict, Tuple

import torch

from repro_torch.kernels.common import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, \
    _nvcc

# the port's kernels by name: flash attention's fa_*, mips_topk.cu's
# mips_*, hamming_topk.cu's hamming_* and lsh_hash.cu's lsh_* (templates
# end the name at "<", plain functions at "(")
PORT_KERNEL = r"((?:fa|mips|hamming|lsh)_\w+?)[<(]"


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, reps: int = 5, pattern: str = PORT_KERNEL,
              launches: dict = None, expect: tuple = (),
              trace: dict = None) -> dict:
    """Device milliseconds per call of each kernel whose name matches
    ``pattern`` (its first group names it) that ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls after a warm-up (empty if the
    profiler sees no device time).  A ``launches`` dict is filled with
    each such kernel's launches per call, as the profiler recorded them.

    The profiler drops records of the first kernels after it starts, so
    a first profiled step of ``reps`` calls is discarded (the schedule's
    warm-up), and each kernel's time is its mean over the launches
    recorded times its launches per call.  A profile that records no
    device time at all, or none for a kernel named in ``expect``, is
    taken again, up to five times, each with twice the calls of the one
    before (a step of a few short kernels can lose every record of
    one).  A ``trace`` dict gets the kept step's window on the host
    clock (``window_us``) and each of its records of such a kernel
    (``records``: name, start and end in microseconds from the window's
    start, and whether it lies inside the window); the host's activity
    is then profiled too, for the step's own record."""
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CUDA]
    if trace is not None:
        activities.append(ProfilerActivity.CPU)
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        calls = reps << attempt
        out, kept, events = {}, [], []

        def ready(p):
            kept.extend(p.key_averages())
            if trace is not None:
                events.extend(p.events())
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        for e in kept:
            name = re.search(pattern, e.key)
            dev_us = getattr(e, "self_device_time_total",
                             e.device_time_total)
            if name and dev_us > 0 and e.count:
                per_call = dev_us / e.count * max(1, round(e.count / calls))
                out[name.group(1)] = out.get(name.group(1), 0.0) + \
                    per_call / 1e3
        if out and all(k in out for k in expect):
            break
    if trace is not None:
        _trace_records(events, pattern, trace)
    if launches is not None:
        for e in kept:
            name = re.search(pattern, e.key)
            if name and e.count:
                launches[name.group(1)] = \
                    launches.get(name.group(1), 0) + e.count / calls
    return out


def _trace_records(events, pattern: str, trace: dict) -> None:
    """Fill ``trace`` (see ``kernel_ms``) from a kept step's events."""
    steps = [e.time_range for e in events
             if e.name.startswith("ProfilerStep")]
    kept = max(steps, key=lambda r: r.start) if steps else None
    w0 = kept.start if kept else 0.0
    w1 = kept.end if kept else float("inf")
    trace["window_us"] = w1 - w0
    trace["records"] = [
        {"name": name.group(1), "start_us": e.time_range.start - w0,
         "end_us": e.time_range.end - w0,
         "in_window": w0 <= e.time_range.start and e.time_range.end <= w1}
        for e in events
        if e.device_type != torch.autograd.DeviceType.CPU
        and (name := re.search(pattern, e.name))]


def device_ms(fn, reps: int = 5) -> float:
    """Device milliseconds per call of everything ``fn`` launches (a
    library call's kernels, whatever their names)."""
    return sum(kernel_ms(fn, reps, pattern=r"^(.+)$").values())


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def instrumented_source(source: str, table: Dict[str, Tuple[str, str]],
                        switches: Tuple[str, ...]) -> str:
    """``source`` with each named switch of ``table`` (``{name: (the
    source text it replaces, the replacement)}``) applied once.  A
    switch whose text does not occur exactly once raises: the copy must
    be the shipped kernel with exactly these parts cut."""
    for name in switches:
        old, new = table[name]
        if source.count(old) != 1:
            raise ValueError(f"switch {name}: its text occurs "
                             f"{source.count(old)} times in the source")
        source = source.replace(old, new)
    return source


def build_variants(kernel: str, table: Dict[str, Tuple[str, str]],
                   variants: Dict[str, Tuple[str, ...]],
                   signatures: Dict[str, tuple]) -> Dict[str, ctypes.CDLL]:
    """``{variant: library}``: ``csrc/<kernel>.cu`` with each variant's
    switches applied, built into ``build/<kernel>_breakdown/`` (one
    ``nvcc`` per variant, started together) and loaded with
    ``signatures`` (``{function: (argtypes, restype)}``)."""
    out_dir = BUILD_DIR / f"{kernel}_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (CSRC_DIR / f"{kernel}.cu").read_text()
    procs = {}
    for name, switches in variants.items():
        src = out_dir / f"{name}.cu"
        src.write_text(instrumented_source(source, table, switches))
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"breakdown build {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs
