"""setup_s: the run's set-up (import, library load and, on a checkout's first
run, its build; weights, traffic, warm-up), host clock."""


def read(run):
    return run.setup_s
