"""Training samples of the steps completed in the window (dispatched
ahead, the window closed by a synchronize), over its seconds."""

UNIT = "samples/s"


def read(run):
    return run.steps * run.batch / run.window_s if run.steps else None
