"""The port's demo CLIs (bpt_tpu_torch.apps) run end to end on the CPU at
16x16, 2 spp, 2 bounces, and write their image."""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.mark.parametrize("app", ["cornell_box", "quadric_geometry", "physical_sky"])
def test_demo_cli_writes_its_image(app, tmp_path, capsys):
    out = tmp_path / f"{app}.png"
    main = importlib.import_module(f"bpt_tpu_torch.apps.{app}").main
    img = main(["--size", "16", "--spp", "2", "--bounces", "2", "--device", "cpu", "--out", str(out)])
    written = [p for p in tmp_path.iterdir() if p.name.startswith(app)]
    assert len(written) == 1 and written[0].stat().st_size > 0
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0.0
    assert f"wrote {written[0]}" in capsys.readouterr().out
