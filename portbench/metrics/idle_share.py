"""The device's idle share in the window: one less the device's busy
seconds a step, from the traced capture's records (the primer, lead-in and
lead-out left out), over the window's seconds a step on the host clock.

The capture's own span is not the window's: under the profiler the host
launches each kernel slower, so the queue that steps dispatched ahead keep
full drains, and the capture's idle share reads the profiler's cost,
which swings from run to run.  The device's busy time a step does not
move with it."""

UNIT = "%"


def read(run):
    tv = run.trace
    if tv is None or not run.steps or tv.busy_s <= 0:
        return None
    busy_per_step = tv.busy_s / run.ctx.traffic["trace_steps"]
    return 100.0 * (1.0 - busy_per_step / (run.window_s / run.steps))
