"""Interactive pygame play loop (reference minigrid/manual_control.py:14-139),
driving the port through its Gymnasium adapter.

Counterpart of ``minigrid_tpu/manual_control.py``. Needs ``gymnasium`` and
``pygame``. ``python -m minigrid_tpu_torch.manual_control --env-id
MiniGrid-WFC-MazeSimple-v0 --device cpu`` plays on the CPU; without
``--device`` the env runs on the card."""

from __future__ import annotations

from minigrid_tpu_torch.compat import GymnasiumAdapter
from minigrid_tpu_torch.core.actions import Actions


class ManualControl:
    def __init__(self, env: GymnasiumAdapter, seed=None):
        self.env = env
        self.seed = seed
        self.closed = False

    def start(self):
        self.reset(self.seed)
        import pygame

        while not self.closed:
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    self.env.close()
                    self.closed = True
                    break
                if event.type == pygame.KEYDOWN:
                    event.key = pygame.key.name(int(event.key))
                    self.key_handler(event)

    def step(self, action: Actions):
        _, reward, terminated, truncated, _ = self.env.step(action)
        print(f"step={self.env.step_count}, reward={reward:.2f}")
        if terminated:
            print("terminated!")
            self.reset(self.seed)
        elif truncated:
            print("truncated!")
            self.reset(self.seed)
        else:
            self.env.render()

    def reset(self, seed=None):
        self.env.reset(seed=seed)
        self.env.render()

    def key_handler(self, event):
        key: str = event.key
        print("pressed", key)

        if key == "escape":
            self.env.close()
            self.closed = True
            return
        if key == "backspace":
            self.reset()
            return

        key_to_action = {
            "left": Actions.left,
            "right": Actions.right,
            "up": Actions.forward,
            "space": Actions.toggle,
            "pageup": Actions.pickup,
            "pagedown": Actions.drop,
            "tab": Actions.pickup,
            "left shift": Actions.drop,
            "enter": Actions.done,
        }
        if key in key_to_action:
            self.step(key_to_action[key])


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--env-id", type=str, default="MiniGrid-MultiRoom-N6-v0",
                        help="gym environment to load")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--tile-size", type=int, default=32)
    parser.add_argument("--agent-view", action="store_true",
                        help="draw what the agent sees")
    parser.add_argument("--agent-view-size", type=int, default=7)
    parser.add_argument("--screen-size", type=int, default=640)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the env (default: the card)")
    args = parser.parse_args()

    env = GymnasiumAdapter(
        args.env_id, render_mode="human", screen_size=args.screen_size,
        tile_size=args.tile_size, agent_pov=args.agent_view,
        device=args.device, view_size=args.agent_view_size,
    )
    ManualControl(env, seed=args.seed).start()


if __name__ == "__main__":
    main()
