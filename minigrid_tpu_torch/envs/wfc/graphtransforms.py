"""Dense layout <-> graph transforms, as batched tensor functions.

Counterpart of ``minigrid_tpu/envs/wfc/graphtransforms.py`` (reference
``minigrid/envs/wfc/graphtransforms.py:96-388``): layouts become one-hot
node-feature planes and edge layers become boolean adjacency tensors over
the inner-cell node set, all fixed-shape tensors on the layouts' device.
Node order is x-major over the border-stripped (W-2, H-2) inner grid (the
analog of the reference's sorted ``nx.grid_2d_graph`` nodes).

The same feature vocabulary and edge descriptors apply
(reference wfcenv.py:16-27, graphtransforms.py:22-40):

- node attributes: ``empty``, ``wall``, ``lava``, ``start``, ``goal`` plus
  the derived ``navigable`` / ``non_navigable`` groups;
- edge layers: ``structure="grid"`` keeps 4-neighbor edges among nodes of
  the listed attributes (reference partial_grid, :334-342), ``structure=None``
  forms the complete product between the attribute sets (reference
  pair_edges, :344-353).
"""

from __future__ import annotations

import dataclasses

import torch

from minigrid_tpu_torch.core import constants as C

# reference graphtransforms.py:22-31
OBJECT_TO_DENSE_GRAPH_ATTRIBUTE = {
    "empty": ("navigable", "empty"),
    "start": ("navigable", "start"),
    "agent": ("navigable", "start"),
    "goal": ("navigable", "goal"),
    "wall": ("non_navigable", "wall"),
    "lava": ("non_navigable", "lava"),
}

# reference wfcenv.py:16-19
FEATURE_DESCRIPTORS = (
    "empty", "wall", "lava", "start", "goal", "navigable", "non_navigable"
)

# reference graphtransforms.py:42-49
MINIGRID_COLOR_CONFIG = {
    "empty": None,
    "wall": "grey",
    "agent": "blue",
    "goal": "green",
    "lava": "red",
}

_ATTR_SOURCE_TYPES = {
    "empty": (C.EMPTY,),
    "wall": (C.WALL,),
    "lava": (C.LAVA,),
    "start": (C.AGENT,),
    "goal": (C.GOAL,),
    "navigable": (C.EMPTY, C.AGENT, C.GOAL),
    "non_navigable": (C.WALL, C.LAVA),
}


@dataclasses.dataclass
class EdgeDescriptor:
    """Which node attributes an edge layer connects, and how
    (reference graphtransforms.py:14-17)."""

    between: tuple[str, ...]
    structure: str | None = None


# reference wfcenv.py:21-27
EDGE_CONFIG = {
    "navigable": EdgeDescriptor(between=("navigable",), structure="grid"),
    "non_navigable": EdgeDescriptor(between=("non_navigable",),
                                    structure="grid"),
    "start_goal": EdgeDescriptor(between=("start", "goal"), structure=None),
}


def grid_adjacency(dim_grid: tuple[int, int], device=None) -> torch.Tensor:
    """(N, N) bool: 4-neighbor adjacency of the x-major node lattice."""
    W, H = dim_grid
    idx = torch.arange(W * H, device=device)
    x, y = idx // H, idx % H
    dx = (x[:, None] - x[None, :]).abs()
    dy = (y[:, None] - y[None, :]).abs()
    return (dx + dy) == 1


def minigrid_layout_to_dense_graph(layouts, remove_border: bool = True,
                                   node_attr=None, edge_config=None):
    """Layout type-planes -> (node features, edge layers).

    layouts: (B, W, H) integer object-type planes (``grid[..., 0]``; stamp
    ``C.AGENT`` at the agent cell for a start node, the analog of
    minigrid_to_dense_graph, reference graphtransforms.py:73-88).
    Returns ``(features, edge_layers)``: ``features`` maps each requested
    attribute to a (B, N) float32 tensor over the x-major node order;
    ``edge_layers`` maps each edge name to a (B, N, N) bool adjacency.
    """
    node_attr = list(FEATURE_DESCRIPTORS) if node_attr is None else node_attr
    layouts = torch.as_tensor(layouts)
    assert layouts.ndim == 3, "expected (batch, W, H) layouts"
    if remove_border:
        layouts = layouts[:, 1:-1, 1:-1]
    B, W, H = layouts.shape

    features = {}
    for attr in node_attr:
        plane = torch.zeros((B, W, H), dtype=torch.bool,
                            device=layouts.device)
        for t in _ATTR_SOURCE_TYPES[attr]:
            plane |= layouts == t
        features[attr] = plane.reshape(B, -1).to(torch.float32)

    edge_layers = get_edge_layers(features, edge_config, (W, H))
    return features, edge_layers


def features_to_dense_graph(features: dict, dim_grid: tuple[int, int],
                            edge_config=None):
    """(features, edge layers) from an existing feature dict
    (reference features_to_dense_graph, graphtransforms.py:161-186)."""
    return features, get_edge_layers(features, edge_config, dim_grid)


def get_edge_layers(features: dict, edge_config, dim_grid: tuple[int, int]):
    """Edge layers per descriptor (reference get_edge_layers, :331-388)."""
    if edge_config is None:
        return {}
    device = next(iter(features.values())).device
    base = grid_adjacency(dim_grid, device)
    layers = {}
    for name, desc in edge_config.items():
        if not set(desc.between).issubset(features.keys()):
            continue  # reference skips incompatible descriptors (:365-368)
        masks = [features[a] > 0.5 for a in desc.between]
        if desc.structure == "grid":
            # 4-neighbor edges among the union of the listed node sets
            nodes = masks[0]
            for m in masks[1:]:
                nodes = nodes | m
            layers[name] = nodes[:, :, None] & nodes[:, None, :] & base
        elif desc.structure is None:
            # complete product between the sets (pair_edges, :344-353)
            pairs = masks[0][:, :, None] & masks[-1][:, None, :]
            layers[name] = pairs | pairs.transpose(1, 2)
        else:
            raise NotImplementedError(
                f"edge structure {desc.structure!r} not supported")
    return layers


def graph_features_to_minigrid(features: dict, shape: tuple[int, int],
                               padding: int = 1) -> torch.Tensor:
    """Node features -> (B, W, H, 3) uint8 encoded layouts with a wall
    ring (reference graph_features_to_minigrid, :188-306): cells default
    to empty, then each attribute stamps its (type, color, 0) encoding;
    with no explicit wall plane, non-navigable cells become walls."""
    W, H = shape
    Wi, Hi = W - 2 * padding, H - 2 * padding
    some = next(iter(features.values()))
    B = some.shape[0]
    dev = some.device

    def enc(obj: str) -> torch.Tensor:
        color = MINIGRID_COLOR_CONFIG.get("agent" if obj == "start" else obj)
        cid = C.COLOR_TO_IDX[color] if color else 0
        tid = C.AGENT if obj == "start" else C.OBJECT_TO_IDX[obj]
        return torch.tensor([tid, cid, 0], dtype=torch.uint8, device=dev)

    grid = torch.zeros((B, Wi, Hi, 3), dtype=torch.uint8, device=dev)
    grid[..., 0] = C.EMPTY

    attrs = list(features.keys())
    for attr in attrs:
        plane = (features[attr] > 0.5).reshape(B, Wi, Hi)
        if attr == "navigable" and "wall" not in attrs:
            grid = torch.where(~plane[..., None], enc("wall"), grid)
        elif attr in ("navigable", "non_navigable"):
            continue
        else:
            grid = torch.where(plane[..., None], enc(attr), grid)

    out = enc("wall").expand(B, W, H, 3).clone()
    out[:, padding:W - padding, padding:H - padding] = grid
    return out


def dense_graph_to_minigrid(features: dict, shape: tuple[int, int],
                            padding: int = 1) -> torch.Tensor:
    """Graph -> encoded layout (reference dense_graph_to_minigrid,
    :308-329). ``features`` must be binary node planes."""
    for attr, f in features.items():
        ok = ((f == 0) | (f == 1)).all()
        assert bool(ok), f"graph features must be binary ({attr})"
    return graph_features_to_minigrid(features, shape, padding)


def minigrid_to_bitmap(grids) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(B, W, H, 3) encoded grids -> (bitmaps, start_pos, goal_pos)
    (reference minigrid_to_bitmap, :52-70): 1 where wall, border stripped,
    positions as (x, y), int32 as JAX's argmax gives them."""
    grids = torch.as_tensor(grids)
    layout = grids[..., 0]
    B, W, H = layout.shape
    bitmap = (layout == C.WALL).to(torch.uint8)[:, 1:-1, 1:-1]
    flat_start = (layout == C.AGENT).reshape(B, -1).to(torch.uint8).argmax(1)
    flat_goal = (layout == C.GOAL).reshape(B, -1).to(torch.uint8).argmax(1)
    start = torch.stack([flat_start // H, flat_start % H], dim=1).to(
        torch.int32)
    goal = torch.stack([flat_goal // H, flat_goal % H], dim=1).to(torch.int32)
    return bitmap, start, goal
