"""The median over the window's calls of the program's own seconds from a
call's entry to its first token on the host (GenerationOutput
.seconds_to_first_token): packing, vision and the prefills."""

import statistics


def read(r):
    return statistics.median(rec.first_s for rec in r.records)
