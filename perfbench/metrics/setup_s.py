"""setup_s: seconds from the run's start to the window's start: the data
checked (generated and preprocessed on a checkout's first run), the store
opened, the engines built, every shape warmed up."""


def read(run):
    return run.setup_s
