"""scan_roofline_share: the least time the window's completed requests
could take on the card, their least bytes (scan_bytes/qNN.json: each base
column the text references, read once) over the card's published memory
bandwidth (peaks.json), as a share of the device's busy time in the trace.
A roofline of whole queries; nothing without a trace or a known peak."""


def read(run):
    if run.trace is None or run.peaks is None or run.trace.busy_s <= 0:
        return None
    least_s = sum(run.scan_bytes[r.qid] for r in run.completed) / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / run.trace.busy_s
