"""Environment catalog (mirrors minigrid/envs/__init__.py exports)."""

from minigrid_tpu_torch.envs.base import MiniGridEnv
from minigrid_tpu_torch.envs.crossing import CrossingEnv
from minigrid_tpu_torch.envs.distshift import DistShiftEnv
from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
from minigrid_tpu_torch.envs.dynamicobstacles import DynamicObstaclesEnv
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.envs.fetch import FetchEnv
from minigrid_tpu_torch.envs.fourrooms import FourRoomsEnv
from minigrid_tpu_torch.envs.gotodoor import GoToDoorEnv
from minigrid_tpu_torch.envs.gotoobject import GoToObjectEnv
from minigrid_tpu_torch.envs.keycorridor import KeyCorridorEnv
from minigrid_tpu_torch.envs.lavagap import LavaGapEnv
from minigrid_tpu_torch.envs.lockedroom import LockedRoomEnv
from minigrid_tpu_torch.envs.memory import MemoryEnv
from minigrid_tpu_torch.envs.multiroom import MultiRoomEnv
from minigrid_tpu_torch.envs.obstructedmaze import (
    ObstructedMaze_1Dlhb,
    ObstructedMaze_Full,
    ObstructedMazeEnv,
)
from minigrid_tpu_torch.envs.playground import PlaygroundEnv
from minigrid_tpu_torch.envs.putnear import PutNearEnv
from minigrid_tpu_torch.envs.redbluedoors import RedBlueDoorEnv
from minigrid_tpu_torch.envs.roomgrid_base import RoomGridEnv
from minigrid_tpu_torch.envs.unlock import (
    BlockedUnlockPickupEnv,
    UnlockEnv,
    UnlockPickupEnv,
)

__all__ = [
    "MiniGridEnv", "CrossingEnv", "DistShiftEnv", "DoorKeyEnv",
    "DynamicObstaclesEnv", "EmptyEnv", "FetchEnv", "FourRoomsEnv",
    "GoToDoorEnv", "GoToObjectEnv", "KeyCorridorEnv", "LavaGapEnv",
    "LockedRoomEnv", "MemoryEnv", "MultiRoomEnv", "ObstructedMazeEnv",
    "ObstructedMaze_1Dlhb", "ObstructedMaze_Full", "PlaygroundEnv",
    "PutNearEnv", "RedBlueDoorEnv", "RoomGridEnv", "UnlockEnv",
    "UnlockPickupEnv", "BlockedUnlockPickupEnv",
]
