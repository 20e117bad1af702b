"""The host's time inside the entry call of the window's requests, ms a
frame pair: the uint8 frames converted to float32 and copied in, the
replay launched, the clone out enqueued. The card has nothing of the
frame to run until the launch, so in a closed loop this time adds to
every frame's."""


def read(run):
    reqs = [r for r in run.requests if r.ok]
    if not reqs:
        return None
    return 1e3 * sum(r.call_end - r.start for r in reqs) / sum(r.fields for r in reqs)
