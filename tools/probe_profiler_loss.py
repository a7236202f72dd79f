"""Which kernel records torch.profiler's traces lose, on a CUDA card.

Trains full-width ResNet-50 v1 as ``chip_smoke.py``'s phase 6 does, then
takes many traces of two training steps each, in turns of four arms:

- ``plain``: the steps alone in the profiler's window;
- ``pad``: the window held open, the device idle, for
  ``chip_smoke.PROFILE_PAD_S`` before the steps;
- ``fillers``: ``chip_smoke.PROFILE_FILLERS`` spin kernels before the steps;
- ``both``: the fillers, then the pad, as ``chip_smoke.profiled_kernels``
  takes its traces.

For each trace it prints the kernel launch calls (``cudaLaunchKernel`` and
its kin) whose kernel has no device record: their count among the fillers
and among the steps' calls, and the positions of the first lost calls in
the trace's launch order.  Every launch call of a step and its kernel share
a CUPTI correlation id, so a lost record shows as a call without its
kernel.

Run from the root of the repo on a machine with a card:

    python3 tools/probe_profiler_loss.py [traces]     # default 80
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def take(step, arm):
    """One trace of two calls of ``step`` under ``arm``; its events."""
    fillers = c.PROFILE_FILLERS if arm in ("fillers", "both") else 0
    pad_s = c.PROFILE_PAD_S if arm in ("pad", "both") else 0.0
    return c._profile_take(step, 2, fillers, pad_s)[0]


def lost_positions(events):
    """Positions, in launch order, of the launch calls without a record."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    recorded = {e.id for e in events if e.device_type == cuda}
    calls = sorted((e for e in events
                    if e.device_type == cpu and "LaunchKernel" in e.name),
                   key=lambda e: e.time_range.start)
    return len(calls), [i for i, e in enumerate(calls)
                        if e.id not in recorded]


def main():
    if not torch.cuda.is_available():
        print("probe_profiler_loss: no CUDA device is visible")
        return 1
    traces = int(sys.argv[1]) if len(sys.argv) > 1 else 80
    card = c.card_line()
    c.phase_build()
    _, _, (ft, x, y) = c.phase_training(card)
    step = lambda: ft.step(x, y)  # noqa: E731
    arms = ("plain", "pad", "fillers", "both")
    worst = {a: (0, 0) for a in arms}
    t0 = time.perf_counter()
    for t in range(traces):
        arm = arms[t % len(arms)]
        calls, lost = lost_positions(take(step, arm))
        skip = c.PROFILE_FILLERS if arm in ("fillers", "both") else 0
        head = sum(1 for i in lost if i < skip)
        body = len(lost) - head
        worst[arm] = (max(worst[arm][0], head), max(worst[arm][1], body))
        print("[probe] trace %d at %.0f s, %-7s: %d launch calls; lost "
              "among the fillers %d, among the steps' calls %d; first lost "
              "positions %s" % (t, time.perf_counter() - t0, arm, calls,
                                head, body, lost[:8]), flush=True)
    for arm in arms:
        print("[probe] %-7s most lost in one trace: among the fillers %d, "
              "among the steps' calls %d" % ((arm,) + worst[arm]))
    print("[probe] on %s" % card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
