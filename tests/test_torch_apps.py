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



def write_glb(path, p0, p1, p2):
    """A GLB with one indexed triangle primitive (positions, normals)."""
    import json
    import struct

    pos = np.stack([p0, p1, p2], axis=1).reshape(-1, 3).astype(np.float32)
    n = np.cross(p1 - p0, p2 - p0)
    n = np.repeat(n / np.linalg.norm(n, axis=-1, keepdims=True), 3, axis=0).astype(np.float32)
    idx = np.arange(pos.shape[0], dtype=np.uint32)
    blob_ = pos.tobytes() + n.tobytes() + idx.tobytes()
    views = [dict(buffer=0, byteOffset=0, byteLength=pos.nbytes),
             dict(buffer=0, byteOffset=pos.nbytes, byteLength=n.nbytes),
             dict(buffer=0, byteOffset=pos.nbytes + n.nbytes, byteLength=idx.nbytes)]
    gltf = dict(asset=dict(version="2.0"), scene=0, scenes=[dict(nodes=[0])],
                nodes=[dict(mesh=0, translation=[0.5, 0.0, 0.0])],
                meshes=[dict(primitives=[dict(attributes=dict(POSITION=0, NORMAL=1), indices=2)])],
                buffers=[dict(byteLength=len(blob_))], bufferViews=views,
                accessors=[dict(bufferView=0, componentType=5126, count=pos.shape[0], type="VEC3"),
                           dict(bufferView=1, componentType=5126, count=pos.shape[0], type="VEC3"),
                           dict(bufferView=2, componentType=5125, count=idx.shape[0], type="SCALAR")])
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    blob_ += b"\0" * (-len(blob_) % 4)
    body = struct.pack("<II", len(js), 0x4E4F534A) + js + struct.pack("<II", len(blob_), 0x004E4942) + blob_
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


def _write_teapot_stand_in(models_dir):
    """A 16-triangle soup under the teapot preset's file name (the glTF
    assets are not in the repository)."""
    rng = np.random.default_rng(4)
    tri = (rng.normal(0, 8, (16, 1, 3)) + rng.normal(0, 3, (16, 3, 3))).astype(np.float32) / 130.0  # preset scale
    models_dir.mkdir()
    write_glb(models_dir / "UtahTeapot.glb", tri[:, 0], tri[:, 1], tri[:, 2])


@pytest.mark.parametrize("app,extra", [("gltf_model", []), ("hdri_environment", ["--nee", "env"]),
                                       ("hdri_environment", [])])
def test_mesh_demo_clis_write_their_image(app, extra, tmp_path, capsys):
    """The glTF and HDRI demos on the CPU at 16x16 with an untextured model
    written to a temporary models directory; a missing asset fails with its
    path."""
    _write_teapot_stand_in(tmp_path / "models")
    out = tmp_path / f"{app}.png"
    main = importlib.import_module(f"bpt_tpu_torch.apps.{app}").main
    argv = ["--size", "16", "--spp", "2", "--bounces", "2", "--device", "cpu", "--model", "teapot",
            "--models-dir", str(tmp_path / "models"), "--out", str(out)] + extra
    img = main(argv)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0.0
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="StanfordBunny"):
        main(argv + ["--model", "bunny"])
