"""ID registration (counterpart of ``minigrid_tpu/register_envs.py``).

The port registers the 76 MiniGrid IDs and the 96 BabyAI IDs, 172 of the JAX
package's 178 (the 6 WaveFunctionCollapse IDs are not ported yet), with the
same IDs and frozen kwargs (``minigrid_tpu/register_envs.py``; reference
minigrid/__init__.py).
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

    _register_roomgrid()
    _register_babyai()


def _register_roomgrid() -> None:
    """The families built with the RoomGrid builder."""
    from minigrid_tpu_torch.envs.keycorridor import KeyCorridorEnv
    from minigrid_tpu_torch.envs.obstructedmaze import (ObstructedMaze_1Dlhb,
                                                        ObstructedMaze_Full)
    from minigrid_tpu_torch.envs.unlock import (BlockedUnlockPickupEnv,
                                                UnlockEnv, UnlockPickupEnv)

    # BlockedUnlockPickup (reference :17-20)
    register("MiniGrid-BlockedUnlockPickup-v0", BlockedUnlockPickupEnv)

    # KeyCorridor (reference :255-288)
    for s, r in ((3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)):
        register(f"MiniGrid-KeyCorridorS{s}R{r}-v0", KeyCorridorEnv,
                 room_size=s, num_rows=r)

    # ObstructedMaze (reference :390-514)
    register("MiniGrid-ObstructedMaze-1Dl-v0", ObstructedMaze_1Dlhb,
             key_in_box=False, blocked=False)
    register("MiniGrid-ObstructedMaze-1Dlh-v0", ObstructedMaze_1Dlhb,
             key_in_box=True, blocked=False)
    register("MiniGrid-ObstructedMaze-1Dlhb-v0", ObstructedMaze_1Dlhb)
    for name, room, box, blocked, quarters, visited in (
            ("2Dl", (2, 1), False, False, 1, 4),
            ("2Dlh", (2, 1), True, False, 1, 4),
            ("2Dlhb", (2, 1), True, True, 1, 4),
            ("1Q", (1, 1), True, True, 1, 5),
            ("2Q", (2, 1), True, True, 2, 11)):
        kw = dict(agent_room=room, key_in_box=box, blocked=blocked,
                  num_quarters=quarters, num_rooms_visited=visited)
        register(f"MiniGrid-ObstructedMaze-{name}-v0", ObstructedMaze_Full,
                 **kw)
        if blocked:  # v1 fixes only the configurations with blockers
            register(f"MiniGrid-ObstructedMaze-{name}-v1",
                     ObstructedMaze_Full, **kw, v1=True)
    register("MiniGrid-ObstructedMaze-Full-v0", ObstructedMaze_Full)
    register("MiniGrid-ObstructedMaze-Full-v1", ObstructedMaze_Full, v1=True)

    # Unlock / UnlockPickup (reference :553-561)
    register("MiniGrid-Unlock-v0", UnlockEnv)
    register("MiniGrid-UnlockPickup-v0", UnlockPickupEnv)


def _register_babyai() -> None:
    """BabyAI language levels (reference minigrid/__init__.py:569-1131)."""
    from minigrid_tpu_torch.envs.babyai import levels as B

    # GoTo family (:570-686)
    register("BabyAI-GoToRedBallGrey-v0", B.GoToRedBallGrey)
    register("BabyAI-GoToRedBall-v0", B.GoToRedBall)
    register("BabyAI-GoToRedBallNoDists-v0", B.GoToRedBallNoDists)
    register("BabyAI-GoToObj-v0", B.GoToObj)
    register("BabyAI-GoToObjS4-v0", B.GoToObj, room_size=4)
    register("BabyAI-GoToObjS6-v1", B.GoToObj, room_size=6)
    register("BabyAI-GoToLocal-v0", B.GoToLocal)
    for s, n in [(5, 2), (6, 2), (6, 3), (6, 4), (7, 4), (7, 5),
                 (8, 2), (8, 3), (8, 4), (8, 5), (8, 6), (8, 7)]:
        register(f"BabyAI-GoToLocalS{s}N{n}-v0", B.GoToLocal, room_size=s,
                 num_dists=n)
    register("BabyAI-GoTo-v0", B.GoTo)
    register("BabyAI-GoToOpen-v0", B.GoTo, doors_open=True)
    register("BabyAI-GoToObjMaze-v0", B.GoTo, num_dists=1, doors_open=False)
    register("BabyAI-GoToObjMazeOpen-v0", B.GoTo, num_dists=1,
             doors_open=True)
    register("BabyAI-GoToObjMazeS4R2-v0", B.GoTo, num_dists=1, room_size=4,
             num_rows=2, num_cols=2)
    for s in (4, 5, 6, 7):
        register(f"BabyAI-GoToObjMazeS{s}-v0", B.GoTo, num_dists=1,
                 room_size=s)
    register("BabyAI-GoToImpUnlock-v0", B.GoToImpUnlock)
    register("BabyAI-GoToSeq-v0", B.GoToSeq)
    register("BabyAI-GoToSeqS5R2-v0", B.GoToSeq, room_size=5, num_rows=2,
             num_cols=2, num_dists=4)
    register("BabyAI-GoToRedBlueBall-v0", B.GoToRedBlueBall)
    register("BabyAI-GoToDoor-v0", B.GoToDoorLevel)
    register("BabyAI-GoToObjDoor-v0", B.GoToObjDoor)

    # Open family (:688-830)
    register("BabyAI-Open-v0", B.Open)
    register("BabyAI-OpenRedDoor-v0", B.OpenRedDoor)
    register("BabyAI-OpenDoor-v0", B.OpenDoor)
    register("BabyAI-OpenDoorDebug-v0", B.OpenDoor, debug=True,
             select_by=None)
    register("BabyAI-OpenDoorColor-v0", B.OpenDoor, select_by="color")
    register("BabyAI-OpenDoorLoc-v0", B.OpenDoor, select_by="loc")
    register("BabyAI-OpenTwoDoors-v0", B.OpenTwoDoors)
    register("BabyAI-OpenRedBlueDoors-v0", B.OpenTwoDoors, first_color="red",
             second_color="blue")
    register("BabyAI-OpenRedBlueDoorsDebug-v0", B.OpenTwoDoors,
             first_color="red", second_color="blue", strict=True)
    for n in (2, 4):
        register(f"BabyAI-OpenDoorsOrderN{n}-v0", B.OpenDoorsOrder,
                 num_doors=n)
        register(f"BabyAI-OpenDoorsOrderN{n}Debug-v0", B.OpenDoorsOrder,
                 debug=True, num_doors=n)

    # Pickup family (:832-886)
    register("BabyAI-Pickup-v0", B.Pickup)
    register("BabyAI-UnblockPickup-v0", B.UnblockPickup)
    register("BabyAI-PickupLoc-v0", B.PickupLoc)
    register("BabyAI-PickupDist-v0", B.PickupDist)
    register("BabyAI-PickupDistDebug-v0", B.PickupDist, debug=True)
    register("BabyAI-PickupAbove-v0", B.PickupAbove)

    # PutNext family (:888-961)
    register("BabyAI-PutNextLocal-v0", B.PutNextLocal)
    register("BabyAI-PutNextLocalS5N3-v0", B.PutNextLocal, room_size=5,
             num_objs=3)
    register("BabyAI-PutNextLocalS6N4-v0", B.PutNextLocal, room_size=6,
             num_objs=4)
    for s, n in [(4, 1), (5, 2), (5, 1), (6, 3), (7, 4)]:
        register(f"BabyAI-PutNextS{s}N{n}-v0", B.PutNext, room_size=s,
                 objs_per_room=n)
    for s, n in [(5, 2), (6, 3), (7, 4)]:
        register(f"BabyAI-PutNextS{s}N{n}Carrying-v0", B.PutNext,
                 room_size=s, objs_per_room=n, start_carrying=True)

    # Unlock family (:963-1014)
    register("BabyAI-Unlock-v0", B.Unlock)
    register("BabyAI-UnlockLocal-v0", B.UnlockLocal)
    register("BabyAI-UnlockLocalDist-v0", B.UnlockLocal, distractors=True)
    register("BabyAI-KeyInBox-v0", B.KeyInBox)
    register("BabyAI-UnlockPickup-v0", B.UnlockPickup)
    register("BabyAI-UnlockPickupDist-v0", B.UnlockPickup, distractors=True)
    register("BabyAI-BlockedUnlockPickup-v0", B.BlockedUnlockPickup)
    register("BabyAI-UnlockToUnlock-v0", B.UnlockToUnlock)

    # Other (:1016-1085)
    register("BabyAI-ActionObjDoor-v0", B.ActionObjDoor)
    register("BabyAI-FindObjS5-v0", B.FindObjS5)
    register("BabyAI-FindObjS6-v0", B.FindObjS5, room_size=6)
    register("BabyAI-FindObjS7-v0", B.FindObjS5, room_size=7)
    register("BabyAI-KeyCorridor-v0", B.KeyCorridor)
    for s, r in [(3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)]:
        register(f"BabyAI-KeyCorridorS{s}R{r}-v0", B.KeyCorridor,
                 room_size=s, num_rows=r)
    for s in (8, 12, 16, 20):
        register(f"BabyAI-OneRoomS{s}-v0", B.OneRoomS8, room_size=s)
    register("BabyAI-MoveTwoAcrossS5N2-v0", B.MoveTwoAcross, room_size=5,
             objs_per_room=2)
    register("BabyAI-MoveTwoAcrossS8N9-v0", B.MoveTwoAcross, room_size=8,
             objs_per_room=9)

    # Synth (:1087-1131)
    register("BabyAI-Synth-v0", B.Synth)
    register("BabyAI-SynthS5R2-v0", B.Synth, room_size=5, num_rows=2)
    register("BabyAI-SynthLoc-v0", B.SynthLoc)
    register("BabyAI-SynthSeq-v0", B.SynthSeq)
    register("BabyAI-MiniBossLevel-v0", B.MiniBossLevel)
    register("BabyAI-BossLevel-v0", B.BossLevel)
    register("BabyAI-BossLevelNoUnlock-v0", B.BossLevelNoUnlock)
