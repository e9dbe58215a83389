"""NCF weights made by the benchmark from the seed, on the device, in the
program's parameter layout (packed ``[n, 2d]`` tables, ``mlp`` a list of
``{"w", "b"}``), and the same leaves by the reference's flat names.

The scales are the NCF initialisation the program also uses: tables
``N(0, 1/d)``, He for the MLP, ``N(0, 0.01)`` for the output layer's
weights.  A served model stands in for a trained one, so its biases are
drawn too (``N(0, 0.01)``); a model about to be trained starts them at 0.
"""

from __future__ import annotations

import math

import torch


def make_tree(g: torch.Generator, n_users: int, n_items: int, embed_dim: int,
              mlp_layers, served: bool) -> dict:
    dev = g.device
    d = embed_dim

    def normal(*shape, std):
        return torch.randn(shape, generator=g, device=dev) * std

    def bias(n):
        return normal(n, std=0.01) if served else torch.zeros(n, device=dev)

    tree = {
        "user_emb": normal(n_users, 2 * d, std=1.0 / math.sqrt(d)),
        "item_emb": normal(n_items, 2 * d, std=1.0 / math.sqrt(d)),
        "mlp": [],
        "out_w": normal(d + mlp_layers[-1], 1, std=0.1),
        "out_b": bias(1),
        "item_bias": bias(n_items),
    }
    fan_in = 2 * d
    for width in mlp_layers:
        tree["mlp"].append({"w": normal(fan_in, width,
                                        std=math.sqrt(2.0 / fan_in)),
                            "b": bias(width)})
        fan_in = width
    return tree


def mlp_dims(cfg: dict) -> list:
    """The tower's ``(in, out)`` per MLP layer of an NCF configuration."""
    dims = [2 * cfg["embed_dim"], *cfg["mlp_layers"]]
    return list(zip(dims[:-1], dims[1:]))


def named_leaves(tree: dict) -> dict:
    """The tree's leaves by the reference's names (the same tensors)."""
    out = {k: v for k, v in tree.items() if k != "mlp"}
    for j, layer in enumerate(tree["mlp"]):
        out[f"mlp.{j}.w"] = layer["w"]
        out[f"mlp.{j}.b"] = layer["b"]
    return out
