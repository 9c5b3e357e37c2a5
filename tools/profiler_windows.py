"""When does a `torch.profiler` window stop recording device time?

In one long process (`chip_smoke.py`) the profiler's windows recorded device
kernels through phases 1-12 and none from phase 16 on. This script opens
windows the way `chip_smoke.py` does (CPU + CUDA activities, one short call
inside, `key_averages()` after) under these conditions, each in a fresh
process, and reports, for every window, how many device events it saw:

- `many`: 4000 windows back to back, each over one small product;
- `child`: 20 windows, then a child process that opens a profiler window of
  its own over one product, then 20 more;
- `child_big`: the same, the child's window over 20,000 launches (as the
  training CLI's `--profile-dir` window over several steps);
- `child_plain`: the same, the child launching 20,000 kernels with no
  profiler;
- `big`: 20 windows, then one window over 100,000 launches, then 20 more;
- `step`, `step10k`, `step20k`: the same with 5,000, 10,000 and 20,000
  launches (one train step takes 3,000 to 10,000);
- `big_wait`: `big`, with 10 s of idle card before the last 20;
- `threads`: 20 windows, then 8 host threads that launch work on the card
  while no window is open, then 20 more.

Run on the card: `python3 tools/profiler_windows.py [--conditions a,b]
[--out FILE]` (~5 min for all). Prints one line per condition and, with
`--out`, writes the per-window readings as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

CHILD = """
import sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
x = torch.randn(256, 256, device="cuda")
launches, profiled = int(sys.argv[1]), sys.argv[2] == "1"


def work():
    y = x
    for _ in range(launches):
        y = y + 1.0
    return y.sum().item()


if profiled:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
    print(sum(ev.device_type == DeviceType.CUDA for ev in prof.events()))
else:
    work()
    print("no profiler")
"""
CHILD_RUNS = {"child": (1, True), "child_big": (20_000, True), "child_plain": (20_000, False)}
BIG = {"big": 100_000, "step": 5_000, "step10k": 10_000, "step20k": 20_000, "big_wait": 100_000}
CONDITIONS = ("many", "child", "child_big", "child_plain", "big", "step", "step10k", "step20k",
              "big_wait", "threads")


def window(fn) -> int:
    """Device events one profiler window over fn() records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_type == DeviceType.CUDA for ev in prof.events())


def run(condition: str) -> dict:
    import torch

    x = torch.randn(256, 256, device="cuda")

    def small():
        return x @ x

    before = [window(small) for _ in range(4000 if condition == "many" else 20)]
    between = None
    if condition in CHILD_RUNS:
        launches, prof = CHILD_RUNS[condition]
        out = subprocess.run([sys.executable, "-c", CHILD, str(launches), str(int(prof))],
                             capture_output=True, text=True, timeout=300)
        between = {"rc": out.returncode, "child_device_events": out.stdout.strip()[-40:]}
    elif condition in BIG:
        def many_launches():
            y = x
            for _ in range(BIG[condition]):
                y = y + 1.0
            return y

        between = {"big_window_device_events": window(many_launches)}
        if condition == "big_wait":
            time.sleep(10)
    elif condition == "threads":
        def work():
            y = torch.randn(512, 512, device="cuda")
            for _ in range(200):
                y = (y @ y).tanh()
            torch.cuda.synchronize()

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        between = {"threads": len(ts)}
    after = [] if condition == "many" else [window(small) for _ in range(20)]
    seen = before + after
    empty = [i for i, n in enumerate(seen) if n == 0]
    return {"condition": condition, "windows": len(seen), "empty": len(empty),
            "first_empty": empty[0] if empty else None, "between": between,
            "after_between_empty": sum(n == 0 for n in after), "events": seen}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--condition", default=None, help="run one condition in this process")
    ap.add_argument("--conditions", default=",".join(CONDITIONS),
                    help="comma-separated conditions, each in a fresh process")
    ap.add_argument("--out", default=None, help="write the readings as JSON here")
    args = ap.parse_args()
    if args.condition:
        print(json.dumps(run(args.condition)))
        return 0
    results = []
    for condition in args.conditions.split(","):
        t = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--condition", condition],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:])
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["seconds"] = time.perf_counter() - t
        results.append(res)
        print(f"[profiler] {condition}: {res['windows']} windows, {res['empty']} with no device "
              f"event (first at {res['first_empty']}); between: {res['between']}; empty after "
              f"it: {res['after_between_empty']}/20; {res['seconds']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
