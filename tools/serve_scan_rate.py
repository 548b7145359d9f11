"""Requests a second of the serving tier's scan classes, on three mixes.

Serves each mix with ``serving.Scheduler(n_slots=4, randomness="fused",
execution="scan")`` at full width (``gmm`` at its default widths, ``ising``
at 1024 x 1024 x 2), once cold and TURNS times warm on the same scheduler,
and prints one JSON line a mix: burst seconds, requests/s and request
steps/s (the requests' own steps over the burst seconds), the advance
signatures counted and the last burst's non-finite final log-probs.  The mixes:

  * ``one_member``: 4 ``ising`` requests of 256 steps (one member, every
    slot full);
  * ``mixed``: 4 ``gmm`` requests of 512 steps and 2 ``ising`` requests of
    256 steps in one class (``chip_smoke.py`` phase 28's burst);
  * ``partial``: 1 ``gmm`` request of 512 steps and 1 ``ising`` request of
    256 steps (a two-member class, half its slots free).

It uses only the scheduler's public surface, so it runs against any tree of
the package: put that tree's ``src`` first on ``PYTHONPATH``.  Needs a CUDA
card:

    PYTHONPATH=src python3 tools/serve_scan_rate.py [LABEL] [TURNS]
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

MIXES = {
    "one_member": [("ising", 256)] * 4,
    "mixed": [("gmm", 512)] * 4 + [("ising", 256)] * 2,
    "partial": [("gmm", 512), ("ising", 256)],
}
# handed to every member's builder, as chip_smoke.py's serving phases do
WIDTHS = {"height": 1024, "width": 1024, "batch": 2}


def burst(serving, mix):
    return [serving.ServeRequest(rid=i, workload=w, n_steps=n, seed=100 + i,
                                 collect="thin:64" if w == "ising" else "all",
                                 t_arrive=0.002 * i)
            for i, (w, n) in enumerate(MIXES[mix])]


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    turns = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    if not torch.cuda.is_available():
        print("serve_scan_rate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import serving

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    for mix in MIXES:
        sched = serving.Scheduler(n_slots=4, randomness="fused", execution="scan",
                                  smoke=False, workload_kwargs=WIDTHS)
        seconds = []
        for _ in range(1 + turns):
            reqs = burst(serving, mix)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sched.serve(reqs)  # returns every request served so far
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if any(r.final_words is None for r in reqs):
                raise SystemExit(f"{mix}: a request of the burst was not served")
            nonfinite = sum(int((~np.isfinite(r.final_logp)).sum()) for r in reqs)
        steps = sum(n for _, n in MIXES[mix])
        warm = seconds[1:]
        print(json.dumps(dict(
            tree=label, mix=mix, requests=len(MIXES[mix]), request_steps=steps,
            cold_s=seconds[0], warm_s=warm,
            warm_requests_per_s=[len(MIXES[mix]) / s for s in warm],
            warm_request_steps_per_s=[steps / s for s in warm],
            shape_classes=sched.shape_classes, signatures=sched.compiled_programs,
            nonfinite_final_logp=nonfinite)),
            flush=True)
        del sched
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
