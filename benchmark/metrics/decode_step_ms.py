"""The median over the window's calls of the decode loop's time a step,
(seconds_total - seconds_to_first_token) / (steps - 1), in ms; nothing
where no call decodes past its first token."""

import statistics


def read(r):
    steps = [(rec.total_s - rec.first_s) / (rec.steps - 1) * 1e3 for rec in r.records if rec.steps > 1]
    return statistics.median(steps) if steps else None
