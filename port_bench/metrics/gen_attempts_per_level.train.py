"""gen_attempts_per_level.train: the BabyAI levels' generation attempts
(first tries included) over the levels asked of them in the window (the
program's ``core/roomgrid.py`` ``COUNTERS.attempts`` / ``.levels``, as
``drivers/train_own.py`` records them)."""


def read(run):
    levels = run.counters.get("gen_levels")
    attempts = run.counters.get("gen_attempts")
    if not levels or attempts is None:
        return None
    return attempts / levels
