"""Where torch.profiler places a card's kernels against their launches.

Runs for DURATION seconds (default 180); about once a second it profiles 20
launches of a small elementwise kernel, once with 5 ms and once with 100 ms
of idle card at each end of the run, and prints one JSON line a session:
the kernels the trace kept, the launch calls it saw, the launches whose
kernel it lost, and (kernel start - launch call start) in microseconds,
least, median and most.  A kernel cannot start before its launch call, so a
negative offset is how far the profiler's conversion of the card's clock
to the host's was off in that session.  Needs a CUDA card:

    python3 tools/profiler_clock.py [DURATION]
"""
import json
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

CUDA = torch.autograd.DeviceType.CUDA


def main() -> int:
    duration = float(sys.argv[1]) if len(sys.argv) > 1 else 180.0
    if not torch.cuda.is_available():
        print("profiler_clock: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    x = torch.zeros(6_000_000, device="cuda")

    def run():
        for _ in range(20):
            x.add_(1.0)

    for _ in range(50):
        run()
    torch.cuda.synchronize()
    while time.perf_counter() - t_start < duration:
        for pad in (0.005, 0.1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                run()
                torch.cuda.synchronize()
                time.sleep(pad)
            raw = prof.profiler.kineto_results.events()
            kernels = {e.correlation_id(): e.start_ns() for e in raw if e.device_type() == CUDA}
            calls = sorted((e for e in raw if e.device_type() != CUDA and "Launch" in e.name()),
                           key=lambda e: e.start_ns())
            lead = [(kernels[c.correlation_id()] - c.start_ns()) / 1e3
                    for c in calls if c.correlation_id() in kernels]
            print(json.dumps(dict(
                t_s=time.perf_counter() - t_start, pad_s=pad, kernels=len(kernels),
                launches=len(calls),
                missing=[i for i, c in enumerate(calls) if c.correlation_id() not in kernels],
                kernel_minus_launch_us=[min(lead), statistics.median(lead), max(lead)]
                if lead else None)), flush=True)
        t = time.perf_counter()  # the card and host busy between sessions
        while time.perf_counter() - t < 1.0:
            run()
        torch.cuda.synchronize()
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
