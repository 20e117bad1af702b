"""Frame pairs (fields) completed in the window over the window's seconds."""


def read(run):
    close = run.outcome.close
    return sum(r.fields for r in run.requests if r.ok and r.end <= close) / run.window_s
