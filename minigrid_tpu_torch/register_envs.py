"""ID registration (counterpart of ``minigrid_tpu/register_envs.py``).

The port registers the 16 MiniGrid families that need no RoomGrid builder
so far (54 of the 76 MiniGrid IDs), with the same IDs and frozen kwargs as
the JAX package (``minigrid_tpu/register_envs.py``; reference
minigrid/__init__.py). Unlock, KeyCorridor and ObstructedMaze follow with
the RoomGrid builder.
"""

from __future__ import annotations

from minigrid_tpu_torch.registry import register

_done = False


def register_all() -> None:
    global _done
    if _done:
        return
    _done = True

    from minigrid_tpu_torch.envs.crossing import CrossingEnv
    from minigrid_tpu_torch.envs.distshift import DistShiftEnv
    from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
    from minigrid_tpu_torch.envs.dynamicobstacles import DynamicObstaclesEnv
    from minigrid_tpu_torch.envs.empty import EmptyEnv
    from minigrid_tpu_torch.envs.fetch import FetchEnv
    from minigrid_tpu_torch.envs.fourrooms import FourRoomsEnv
    from minigrid_tpu_torch.envs.gotodoor import GoToDoorEnv
    from minigrid_tpu_torch.envs.gotoobject import GoToObjectEnv
    from minigrid_tpu_torch.envs.lavagap import LavaGapEnv
    from minigrid_tpu_torch.envs.lockedroom import LockedRoomEnv
    from minigrid_tpu_torch.envs.memory import MemoryEnv
    from minigrid_tpu_torch.envs.multiroom import MultiRoomEnv
    from minigrid_tpu_torch.envs.playground import PlaygroundEnv
    from minigrid_tpu_torch.envs.putnear import PutNearEnv
    from minigrid_tpu_torch.envs.redbluedoors import RedBlueDoorEnv

    # DoorKey (reference minigrid/__init__.py:93-115)
    register("MiniGrid-DoorKey-5x5-v0", DoorKeyEnv, size=5)
    register("MiniGrid-DoorKey-6x6-v0", DoorKeyEnv, size=6)
    register("MiniGrid-DoorKey-8x8-v0", DoorKeyEnv, size=8)
    register("MiniGrid-DoorKey-16x16-v0", DoorKeyEnv, size=16)

    # Empty (reference minigrid/__init__.py:117-160)
    register("MiniGrid-Empty-5x5-v0", EmptyEnv, size=5)
    register("MiniGrid-Empty-Random-5x5-v0", EmptyEnv, size=5,
             agent_start_pos=None)
    register("MiniGrid-Empty-6x6-v0", EmptyEnv, size=6)
    register("MiniGrid-Empty-Random-6x6-v0", EmptyEnv, size=6,
             agent_start_pos=None)
    register("MiniGrid-Empty-8x8-v0", EmptyEnv)
    register("MiniGrid-Empty-16x16-v0", EmptyEnv, size=16)

    # Crossing (reference :24-73)
    for size, n in ((9, 1), (9, 2), (9, 3), (11, 5)):
        register(f"MiniGrid-LavaCrossingS{size}N{n}-v0", CrossingEnv,
                 size=size, num_crossings=n)
        register(f"MiniGrid-SimpleCrossingS{size}N{n}-v0", CrossingEnv,
                 size=size, num_crossings=n, obstacle_type="wall")

    # DistShift (reference :78-88)
    register("MiniGrid-DistShift1-v0", DistShiftEnv, strip2_row=2)
    register("MiniGrid-DistShift2-v0", DistShiftEnv, strip2_row=5)

    # Dynamic-Obstacles (reference :120-153)
    for size, n in ((5, 2), (6, 3)):
        register(f"MiniGrid-Dynamic-Obstacles-{size}x{size}-v0",
                 DynamicObstaclesEnv, size=size, n_obstacles=n)
        register(f"MiniGrid-Dynamic-Obstacles-Random-{size}x{size}-v0",
                 DynamicObstaclesEnv, size=size, agent_start_pos=None,
                 n_obstacles=n)
    register("MiniGrid-Dynamic-Obstacles-8x8-v0", DynamicObstaclesEnv)
    register("MiniGrid-Dynamic-Obstacles-16x16-v0", DynamicObstaclesEnv,
             size=16, n_obstacles=8)

    # Fetch (reference :196-208)
    register("MiniGrid-Fetch-5x5-N2-v0", FetchEnv, size=5, numObjs=2)
    register("MiniGrid-Fetch-6x6-N2-v0", FetchEnv, size=6, numObjs=2)
    register("MiniGrid-Fetch-8x8-N3-v0", FetchEnv)

    # FourRooms (reference :213-216)
    register("MiniGrid-FourRooms-v0", FourRoomsEnv)

    # GoToDoor (reference :221-235)
    register("MiniGrid-GoToDoor-5x5-v0", GoToDoorEnv)
    register("MiniGrid-GoToDoor-6x6-v0", GoToDoorEnv, size=6)
    register("MiniGrid-GoToDoor-8x8-v0", GoToDoorEnv, size=8)

    # GoToObject (reference :241-249)
    register("MiniGrid-GoToObject-6x6-N2-v0", GoToObjectEnv)
    register("MiniGrid-GoToObject-8x8-N2-v0", GoToObjectEnv, size=8,
             numObjs=2)

    # LavaGap (reference :294-309)
    for size in (5, 6, 7):
        register(f"MiniGrid-LavaGapS{size}-v0", LavaGapEnv, size=size)

    # LockedRoom (reference :315-318)
    register("MiniGrid-LockedRoom-v0", LockedRoomEnv)

    # Memory (reference :323-356)
    register("MiniGrid-MemoryS17Random-v0", MemoryEnv, size=17,
             random_length=True)
    register("MiniGrid-MemoryS13Random-v0", MemoryEnv, size=13,
             random_length=True)
    for size in (13, 11, 9, 7):
        register(f"MiniGrid-MemoryS{size}-v0", MemoryEnv, size=size)

    # MultiRoom (reference :362-384; N4-S5-v0 is the documented legacy
    # misconfiguration for 6 rooms)
    register("MiniGrid-MultiRoom-N2-S4-v0", MultiRoomEnv, minNumRooms=2,
             maxNumRooms=2, maxRoomSize=4)
    register("MiniGrid-MultiRoom-N4-S5-v0", MultiRoomEnv, minNumRooms=6,
             maxNumRooms=6, maxRoomSize=5)
    register("MiniGrid-MultiRoom-N4-S5-v1", MultiRoomEnv, minNumRooms=4,
             maxNumRooms=4, maxRoomSize=5)
    register("MiniGrid-MultiRoom-N6-v0", MultiRoomEnv, minNumRooms=6,
             maxNumRooms=6)

    # Playground (reference :519-522)
    register("MiniGrid-Playground-v0", PlaygroundEnv)

    # PutNear (reference :527-535)
    register("MiniGrid-PutNear-6x6-N2-v0", PutNearEnv)
    register("MiniGrid-PutNear-8x8-N3-v0", PutNearEnv, size=8, numObjs=3)

    # RedBlueDoors (reference :540-548)
    register("MiniGrid-RedBlueDoors-6x6-v0", RedBlueDoorEnv, size=6)
    register("MiniGrid-RedBlueDoors-8x8-v0", RedBlueDoorEnv)
