"""Timing helpers shared by chip_smoke.py and the tools that time the
port's kernels."""
import subprocess
import time

# profiles taken before a device time is given up as "not measured"
PROFILE_TRIES = 3
# host idle time inside a profile window, before the first launch and
# after the synchronize.  The profiler keeps only the device records that
# fall inside its window on the host's clock, and the card's timestamps
# are off the host's by up to a few ms, drifting over a process's life
# (tools/profiler_check.py): records of a window of a few ms fell outside
# it and were dropped.
PROFILE_PAD_S = 0.05


def padded_profile(pad=PROFILE_PAD_S):
    """A torch.profiler window (CPU and CUDA activities) that idles the
    host ``pad`` seconds after it opens and before it closes; the caller
    synchronizes the card before leaving the ``with``."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def window():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            yield prof
            time.sleep(pad)
    return window()


def profile_kernels(torch, fn, reps, pad=PROFILE_PAD_S):
    """One padded profiler window (``pad`` seconds each side) around
    ``reps`` calls of ``fn`` and a synchronize.  Returns per kernel name (device-side events only) its
    total device ms and its number of recorded launches."""
    from torch.autograd import DeviceType
    with padded_profile(pad) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        ms, n = out.get(e.key[:60], (0.0, 0))
        out[e.key[:60]] = (ms + us / 1e3, n + e.count)
    return out


def kernel_ms(torch, fn, reps, tries=PROFILE_TRIES):
    """Device time per call of ``fn`` by kernel name: the kernels
    torch.profiler records over ``reps`` calls (after one call to warm
    up), each kernel's total over ``reps``.  A profile is complete if it
    recorded every launch: each kernel a whole multiple of ``reps``
    times.  Up to ``tries`` profiles are taken for a complete one; on
    some hosts, once a process has run for a while, every window loses a
    record or two at its edges (PERF.md §7), and then the last profile
    gives each kernel's mean over the launches it recorded times its
    launches per call (records over ``reps``, rounded).  Returns (per
    kernel, profiles taken, launches per kernel the last profile
    recorded); per kernel is empty when a kernel has too few records to
    tell its launches per call, or there is none."""
    fn()
    torch.cuda.synchronize()
    for k in range(1, tries + 1):
        rec = profile_kernels(torch, fn, reps)
        counts = {name: n for name, (_, n) in rec.items()}
        if rec and all(n % reps == 0 for n in counts.values()):
            return ({name: ms / reps for name, (ms, _) in rec.items()}, k,
                    counts)
    calls = {name: round(n / reps) for name, n in counts.items()}
    if not rec or not all(calls.values()):
        return {}, tries, counts
    return ({name: ms / n * calls[name] for name, (ms, n) in rec.items()},
            tries, counts)


def device_ms(torch, fn, reps=20):
    """Device time per call, every kernel of a call summed, or "not
    measured"; the number of profiles taken and the launches per kernel
    the last one recorded (``kernel_ms``)."""
    per, tries, counts = kernel_ms(torch, fn, reps)
    return (sum(per.values()) if per else "not measured"), tries, counts


def event_ms(torch, fn, reps, warmup=3):
    """CUDA events around ``reps`` back-to-back calls, after ``warmup``
    calls: ms per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sm_clock_mhz(torch, fn):
    """The SM clock and its maximum (MHz) as nvidia-smi reads them while
    ``fn`` runs back to back on the card."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
        text=True)
    while proc.poll() is None:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    out = proc.communicate()[0].strip().splitlines()[0]
    sm, sm_max = (float(v) for v in out.split(","))
    return sm, sm_max
