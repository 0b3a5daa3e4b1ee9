"""launch_calls_per_request: CUDA runtime and driver launch calls in the
trace (names holding ``LaunchKernel`` or ``GraphLaunch``) over the traced
requests."""


def read(run):
    if not run.traces or not run.traced_units or not run.traces[0].launches:
        return None
    return run.traces[0].launches / run.traced_units
