"""fps: frames fed in the window over the time from the first call to the
return of the closing flush() (host clock)."""


def read(run):
    return run.frames / run.window_s
