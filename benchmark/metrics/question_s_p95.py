"""The 95th percentile of each question's wall time, from entering the
engine's entry to its return, over every question of the window."""

import numpy as np


def read(r):
    return float(np.percentile(r.question_seconds(), 95))
