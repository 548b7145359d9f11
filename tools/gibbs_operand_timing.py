"""Device time of the operand Gibbs kernel (``gibbs_chain``) at its timed
shapes (``chip_smoke.py:OPERAND_SHAPES``), for one or more checkouts of
the port, on one card.

    python3 tools/gibbs_operand_timing.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); each is measured
in its own process, in the order given, so that two versions of
``csrc/gibbs.cu`` can be compared in turns on one card (A B B A).  At each
shape the wrapper is held against its plain version at tolerance 0, then
timed: CUDA events around 20 wrapper calls (5 at 1024 x 1024), and the
profiler's device time over as many calls, with the device kernels a call
runs (the half-sweep kernel K times a call, the band kernel once a lattice
group).  The bound is ``chip_smoke.py:gibbs_cost``'s.  One JSON line a
shape, after a line with the card's name and power limit.  Needs a card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEED = 2024


def measure(root: Path) -> None:
    import torch

    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.gibbs import gibbs as gk
    from repro_torch.kernels.gibbs import ref as gref

    # the half-sweep design (before the band kernel took the operand
    # draw) launches K kernels a call and counts one
    half_sweeps = "gibbs_sweep_kernel" in (root / "src/repro_torch/csrc/gibbs.cu").read_text()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, b, h, w, k, glass in cs.OPERAND_SHAPES:
        init = torch.randint(0, 2, (b, h, w), generator=gen, device=dev)
        u = cs.operand_uniforms(torch, gen, (k, b, h, w))
        parity0 = torch.arange(b, device=dev) % 2
        logit = cs.lattice_logit(torch, gref, gen, h, w, glass)
        args = (init, u, logit, parity0)
        s, f = gk.gibbs_chain(*args)
        rs, rf = gref.gibbs_chain_ref(*args)
        diff = int((s != rs).sum()) + int((f != rf).sum())
        cs.check(diff == 0, f"{root}: gibbs_chain differs from its plain version at {label}")
        reps = 5 if h * w * b > 1e6 else 20
        per_call = k if half_sweeps else 1
        events = cs.traced(torch, lambda: [gk.gibbs_chain(*args) for _ in range(reps)],
                           "gibbs", lambda: gk.LAUNCHES["gibbs_chain"] * per_call)[0]
        kernels = [e for e in events if "gibbs" in e.name]
        nbytes, ops, *_ = cs.gibbs_cost("gibbs_chain", args, {})
        bound, bound_by = cs.bound_ms(nbytes, ops)
        device = sum(e.self_device_time_total for e in kernels) / reps / 1e3
        cs.emit(root=str(root), shape=label, B=b, H=h, W=w, K=k, mismatches=diff,
                device_ms=device, kernels_per_call=len(kernels) / reps,
                ms=cs.time_ms(torch, lambda: gk.gibbs_chain(*args), reps),
                bound_ms=bound, bound_by=bound_by, share_of_bound=bound / device,
                kernel_names=sorted({e.name[:80] for e in kernels}))
        del init, u, s, f, rs, rf


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gibbs_operand_timing: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(Path(sys.argv[2]).resolve())
        return 0
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    print(cs.smi(), flush=True)
    for root in sys.argv[1:] or [str(HERE)]:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
        print(json.dumps(dict(root=root, seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
