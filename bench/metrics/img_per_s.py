"""img_per_s: images answered inside the window over the window's seconds."""


def read(run):
    return run.completed_in_window / run.seconds
