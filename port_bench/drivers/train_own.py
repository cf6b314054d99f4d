"""Driver of the train cells whose episodes each have a budget of their
own (BabyAI's LevelGen levels): ``drivers/train.py``'s closed loop of
``make_train_step(resets="fresh")``, with each env's step count staggered
uniformly below its own budget, as a PPO run has them at steady state, and
the fresh buffer sized from the start batch's budgets,
``int(T * sum(1 / budget) * factor) + extra`` rows a rollout. The window
also records how many levels the generators were asked for and how many
attempts they made (``core/roomgrid.py::COUNTERS``), for
``gen_attempts_per_level.train``; a program without those counters is
refused at set-up."""

from __future__ import annotations

import torch

from drivers.train import TrainLoop

COUNTS = ("levels", "attempts")


def make(run):
    return OwnBudgetLoop(run)


def _gen_counts():
    from minigrid_tpu_torch.core import roomgrid

    return tuple(getattr(roomgrid.COUNTERS, n) for n in COUNTS)


class OwnBudgetLoop(TrainLoop):
    def setup(self):
        from minigrid_tpu_torch.core import roomgrid

        missing = [n for n in COUNTS if not hasattr(roomgrid.COUNTERS, n)]
        if missing:
            raise RuntimeError(
                "core/roomgrid.py's COUNTERS has no "
                + ", ".join(missing) + ": this cell reads the generators' "
                "levels and attempts (port_bench/README.md lists the "
                "program's names the harness hooks)")
        super().setup()

    def _stagger_budget(self, st, g):
        budget = st.extra["max_steps"].to(torch.float64)
        u = torch.rand(self.B, generator=g, device=st.device,
                       dtype=torch.float64)
        steps = torch.minimum((u * budget).floor(), budget - 1)
        st = st.replace(step_count=steps.to(torch.int32))
        rule = self.traffic["fresh_buffer"]
        rows = int(self.T * float((1 / budget).sum()) * rule["factor"])
        return st, rows + rule["extra"]

    def window(self, seconds):
        before = _gen_counts()
        super().window(seconds)
        after = _gen_counts()
        for name, a, b in zip(COUNTS, before, after):
            self.run.counters[f"gen_{name}"] = b - a
