"""A listed kernel's share of its roofline over the profiled slice."""


def share(run, kernel: str, names: tuple[str, ...]):
    bound = run.kernel_bounds.get(kernel)
    t = sum(s for n, s in run.trace.by_name.items()
            if any(k in n for k in names))
    if not bound or t <= 0:
        return None
    return 100.0 * bound * run.trace.calls / t
