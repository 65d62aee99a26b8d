"""setup_s: seconds from the process's start to the first timed unit of
work: imports, kernel libraries loaded (or built, in a checkout's first
run), weights made and packed on the device, inputs made, warm-up."""


def read(ctx):
    return ctx["setup_s"]
