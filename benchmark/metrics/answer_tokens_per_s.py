"""Answer tokens served (every question's, not its branch rows') over the
seconds from the window's start to the last answer."""


def read(r):
    return r.answer_tokens / r.window_s
