"""The ``cornell`` configuration: the reference's Cornell box with two
spheres, the quad light on the ceiling, no environment, quad-light NEE
(``cornell.json`` holds its sizes).  The inverse problem of its train cells
is the light's emission: quad 5's colour is emission * (1, 1, 1)."""

from __future__ import annotations

import torch

from benchmark.reference.scenes.cornell import cornell_scene


def make_inputs(spec: dict, seed: int, device) -> dict:
    """The scene on the host; nothing in it is drawn from the seed."""
    return {"scene": cornell_scene(**spec["scene"])}


def reference_scene(inputs: dict, device):
    return inputs["scene"].to(device)


def program_scene(inputs: dict, device):
    from benchmark.sides import to_port

    return to_port(inputs["scene"]).to(device)


def apply(scene, params: dict):
    """The scene with the light's colour set from ``params["emission"]``
    (either side's types)."""
    color = scene.quads.color
    light = torch.as_tensor(params["emission"], dtype=torch.float32, device=color.device) * torch.ones(
        3, dtype=torch.float32, device=color.device)
    return scene._replace(quads=scene.quads._replace(color=torch.cat([color[:-1], light[None]])))


def train_values(spec: dict, inputs: dict, device) -> tuple[dict, dict]:
    """(true parameters, initial parameters) of the job."""
    train = spec["train"]
    return ({"emission": torch.tensor(float(train["true"]), device=device)},
            {"emission": torch.tensor(float(train["init"]), device=device)})
