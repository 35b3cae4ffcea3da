"""Timing helpers shared by the tools that time the port's kernels."""


def kernel_ms(torch, fn, reps):
    """Device time per call of ``fn`` by kernel name: the kernels
    torch.profiler records over ``reps`` calls (after one call to warm
    up), each kernel's total over ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        per[e.key[:60]] = per.get(e.key[:60], 0.0) + us / 1e3 / reps
    return per


def device_ms(torch, fn, reps):
    """Device time per call: every kernel of a call summed, or "not
    measured" where the profiler recorded none."""
    total = sum(kernel_ms(torch, fn, reps).values())
    return total if total > 0 else "not measured"


def event_ms(torch, fn, reps):
    """CUDA events around ``reps`` back-to-back calls, after 3 to warm
    up: ms per call."""
    for _ in range(3):
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
