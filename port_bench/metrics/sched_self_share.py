"""Share of the scheduler's run that the host spends in the scheduler's own
code, outside the runner's calls: the self seconds of the scheduler's spans
(``rt.sched.run`` and its ``admit``, ``release`` and ``health`` children;
the runner's spans are their other children) over the seconds of
``rt.sched.run``, in percent, in the traced call of ``spans/program.py``."""
SPANS = ("program",)


def read(m):
    sp = m.spans
    if sp is None:
        return None
    run = sp.host_s.get("rt.sched.run")
    own = [v for k, v in sp.host_s.items() if k.startswith("rt.sched.") and k.endswith(".self")]
    if not run or not own:
        return None
    return 100.0 * sum(own) / run
