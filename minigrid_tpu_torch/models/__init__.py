from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                    ActorCriticRNN,
                                                    encode_obs, init_params,
                                                    init_params_rnn)
from minigrid_tpu_torch.models.bc import behavior_clone
from minigrid_tpu_torch.models.eval import evaluate_success
from minigrid_tpu_torch.models.ppo import (PPOConfig, make_optimizer,
                                           make_train_loop, make_train_step)
from minigrid_tpu_torch.models.train import TrainConfig, train

__all__ = [
    "ActorCritic", "ActorCriticRNN", "encode_obs", "init_params",
    "init_params_rnn", "evaluate_success", "behavior_clone", "PPOConfig",
    "make_optimizer", "make_train_loop", "make_train_step", "TrainConfig",
    "train",
]
