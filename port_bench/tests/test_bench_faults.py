"""A run with the timed path broken underneath reads ``correct`` false:
once for each fault the cells can have. (One chip: no exchange between
chips to leave out.)"""

import pytest
import torch

from bench_test_util import run_tiny

TRAIN = "doorkey8x8.train_pooled"
FRESH = "putnextlocal.train_fresh"
VECTOR = "doorkey8x8.vector_regen"


@pytest.mark.parametrize("cell", [TRAIN, FRESH])
def test_an_optimizer_step_that_leaves_the_state_unchanged(monkeypatch,
                                                            cell):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = run_tiny(cell)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", [TRAIN, FRESH])
def test_half_of_the_batch_left_out_of_the_loss(monkeypatch, cell):
    from minigrid_tpu_torch.models import ppo as PPO

    inner = PPO.ppo_loss

    def half(model, cfg, mb, mesh=None):
        B = mb["adv"].shape[1]
        return inner(model, cfg, {k: v[:, :B // 2] for k, v in mb.items()},
                     mesh)

    monkeypatch.setattr(PPO, "ppo_loss", half)
    out = run_tiny(cell)
    assert not out["correct"]
    grad = out["checks"]["grad_gap"]
    assert grad["value"] > grad["limit"]


def test_a_reward_altered_where_it_is_produced(monkeypatch):
    from minigrid_tpu_torch.envs import base

    inner = base.autoreset_step_presampled

    def altered(env, keys, states, actions, reset_row):
        out = list(inner(env, keys, states, actions, reset_row))
        out[2] = out[2].clone()
        out[2][0] += 0.5
        return tuple(out)

    monkeypatch.setattr(base, "autoreset_step_presampled", altered)
    out = run_tiny(TRAIN)
    assert not out["correct"]
    assert out["checks"]["env_mismatches"]["value"] > 0


def test_a_fresh_reset_altered_where_it_is_produced(monkeypatch):
    from minigrid_tpu_torch.envs import base

    inner = base.fresh_candidates

    def shifted(keys, done, buffer, cursor, window, finishers=None):
        cand, overflow, cursor = inner(keys, done, buffer, cursor + 1,
                                       window, finishers)
        return cand, overflow, cursor

    monkeypatch.setattr(base, "fresh_candidates", shifted)
    out = run_tiny(FRESH)
    assert not out["correct"]
    assert out["checks"]["env_mismatches"]["value"] > 0


def test_an_env_step_that_returns_its_state_unchanged(monkeypatch):
    from minigrid_tpu_torch.envs import base

    inner = base.MiniGridEnv.step_autoreset

    def frozen(self, keys, states, actions, generator, layouts=None):
        out = inner(self, keys, states, actions, generator, layouts)
        return (out[0], states) + tuple(out[2:])

    monkeypatch.setattr(base.MiniGridEnv, "step_autoreset", frozen)
    out = run_tiny(VECTOR)
    assert not out["correct"]


def test_an_observation_altered_where_it_is_produced(monkeypatch):
    from minigrid_tpu_torch.envs import base

    inner = base.MiniGridEnv.step_autoreset

    def altered(self, keys, states, actions, generator, layouts=None):
        out = inner(self, keys, states, actions, generator, layouts)
        obs = dict(out[0], packed=out[0]["packed"].clone())
        obs["packed"][0, 0, 0] ^= 1
        return (obs,) + tuple(out[1:])

    monkeypatch.setattr(base.MiniGridEnv, "step_autoreset", altered)
    out = run_tiny(VECTOR)
    assert not out["correct"]


def _stale(env, generator, pool):
    return pool


def _agents_of_other_rows(env, generator, pool):
    import minigrid_tpu_torch as mt

    new = mt.envs.base.make_layout_pool(env, generator, pool.size)
    return new.replace(scal=new.scal.roll(1, 0))


@pytest.mark.parametrize("refresh", [_stale, _agents_of_other_rows],
                         ids=["pool_kept", "agents_of_other_rows"])
def test_a_pool_refresh_broken_where_it_is_produced(monkeypatch, refresh):
    import minigrid_tpu_torch as mt

    monkeypatch.setattr(mt, "refresh_layout_pool", refresh)
    out = run_tiny(TRAIN)
    assert not out["correct"]
    assert out["checks"]["env_mismatches"]["value"] > 0
