"""train_env_steps_per_s: global batch x rollout length x the train steps
completed in the window, over the window's seconds (closed by a
synchronisation), host clock."""


def read(run):
    w = run.window
    if not w.get("seconds") or "steps" not in w:
        return None
    return w["env_steps"] / w["seconds"]
