"""gen_host_syncs.train: host syncs the RoomGrid and BabyAI generators
counted (the program's ``core/roomgrid.py`` ``COUNTERS.host_syncs``), per
train step of the traced window."""


def read(run):
    syncs = run.counters.get("gen_host_syncs")
    steps = run.window.get("steps")
    if syncs is None or not steps:
        return None
    return syncs / steps
