"""Questions answered over the seconds from the window's start to the last answer."""


def read(r):
    return r.questions / r.window_s
