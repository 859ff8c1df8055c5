"""How many of a short trace's device events torch.profiler keeps, over a
long run with the card under load.

Every ~8 s of 4096 x 4096 float32 matmuls it takes four traces of the same
20 launches of a one-microsecond kernel (an add over 65,536 floats):
CUDA activity alone and CPU + CUDA, each with no idle time and with 50 ms
of idle time inside the window at both ends.  Each line is one JSON object:
``t`` (seconds since the start) and, per trace, [kernel events kept, first
and last kept kernel's start (us), first CPU event's start (us), the trace's
host time (us)].  ``chip_smoke.py``'s ``device_profile`` pads its windows
on this evidence.

    python3 profile_window_probe.py [SECONDS]     # default 360; needs a card

With ``--variants WARM SECONDS`` it first loads the card for WARM seconds,
then until SECONDS have passed repeats rounds in which each of four
windows (no idle time, 50 ms of idle time at the start, at the end, at
both ends) traces 20 calls of a short kernel (the add, ~1 us) and of a
longer one (a 1024 x 1024 matmul) as ``chip_smoke.py``'s ``device_profile``
does: a call and a synchronize, then the trace, each after 0.5 s of
matmul load.  It prints each round's kept counts and, last, per window
and kernel, the traces taken, empty and partial.
"""
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("profile_window_probe.py needs a CUDA card")
dur = float(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1] != "--variants" else 360.0
x = torch.rand(65536, device="cuda")
a = torch.rand(4096, 4096, device="cuda")
t_start = time.perf_counter()


def session(acts, pad):
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        if pad:
            time.sleep(pad)
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    host_us = 1e6 * (time.perf_counter() - t0)
    ks = sorted(e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CUDA and "elementwise" in e.name)
    cpu = sorted(e.time_range.start for e in prof.events() if e.device_type == DeviceType.CPU)
    return [len(ks), round(ks[0]) if ks else None, round(ks[-1]) if ks else None,
            round(cpu[0]) if cpu else None, round(host_us)]


def sample():
    c, cc = [ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return {"t": round(time.perf_counter() - t_start, 1),
            "cuda": session(c, 0.0), "cuda_pad": session(c, 0.05),
            "cpucuda": session(cc, 0.0), "cpucuda_pad": session(cc, 0.05)}




def load(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def variants(warm, until):
    m = torch.rand(1024, 1024, device="cuda")
    fns = {"add": (lambda: x.add_(1.0), "elementwise"), "matmul": (lambda: m @ m, "")}
    pads = {"none": (0.0, 0.0), "start": (0.05, 0.0), "end": (0.0, 0.05), "both": (0.05, 0.05)}
    tally = {f"{p} {f}": [0, 0, 0] for p in pads for f in fns}
    load(warm)
    while time.perf_counter() - t_start < until:
        row = {"t": round(time.perf_counter() - t_start, 1)}
        for pname, (pre, post) in pads.items():
            for fname, (fn, key) in fns.items():
                load(0.5)
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    time.sleep(pre)
                    for _ in range(20):
                        fn()
                    torch.cuda.synchronize()
                    time.sleep(post)
                n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and key in e.key)
                row[f"{pname} {fname}"] = n
                t = tally[f"{pname} {fname}"]
                t[0] += 1
                t[1] += n == 0
                t[2] += 0 < n < 20
        print(json.dumps(row), flush=True)
    print(json.dumps({"traces, empty, partial": tally}), flush=True)


if sys.argv[1:2] == ["--variants"]:
    variants(float(sys.argv[2]), float(sys.argv[3]))
    sys.exit(0)
print(json.dumps(sample()), flush=True)
while time.perf_counter() - t_start < dur:
    t = time.perf_counter()
    while time.perf_counter() - t < 8:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
    print(json.dumps(sample()), flush=True)
