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


@pytest.mark.parametrize("app", ["gltf_model", "hdri_environment"])
def test_mesh_demo_reorder_flag_renders_the_same_image(app, tmp_path):
    """--reorder traces each batch of samples as one staged pool (here its
    plain phases on the CPU): the image equals the sample-at-a-time one."""
    _write_teapot_stand_in(tmp_path / "models")
    main = importlib.import_module(f"bpt_tpu_torch.apps.{app}").main
    argv = ["--size", "16", "--spp", "3", "--bounces", "2", "--device", "cpu", "--model", "teapot",
            "--models-dir", str(tmp_path / "models"), "--out", str(tmp_path / f"{app}.png")]
    np.testing.assert_array_equal(main(argv + ["--reorder"]), main(argv))


def test_debug_low_res_renders_small_and_upscales(tmp_path, capsys):
    """debug_low_res at --device cpu on the stand-in: a 64 canvas at pixel
    resolution 0.25 traces 16x16 (size x resolution rounded to a multiple
    of 8, at least 8) and writes the 4x nearest-neighbour upscale beside
    it; --mobile runs with eps_intersect 1.0; a missing asset fails with its
    path."""
    from bpt_tpu_torch.apps import debug_low_res

    assert [debug_low_res.render_size(s, r) for s, r in ((256, 0.1), (64, 0.25), (40, 0.1), (1024, 0.5))] == \
        [24, 16, 8, 512]
    _write_teapot_stand_in(tmp_path / "models")
    argv = ["--size", "64", "--pixel-resolution", "0.25", "--spp", "2", "--bounces", "2", "--device", "cpu",
            "--models-dir", str(tmp_path / "models"), "--out", str(tmp_path / "low.png")]
    up = debug_low_res.main(argv)
    out = capsys.readouterr().out
    assert "rendering 16x16" in out and "output 64x64" in out
    assert up.shape == (64, 64, 3) and np.isfinite(up).all() and up.max() > 0.0
    blocks = up.reshape(16, 4, 16, 4, 3)
    assert (blocks == blocks[:, :1, :, :1]).all()  # each traced pixel fills a 4x4 block
    assert (tmp_path / "low.png").exists() and any(p.name.startswith("low_upscaled") for p in tmp_path.iterdir())
    mobile = debug_low_res.main(argv + ["--mobile"])
    assert mobile.shape == (64, 64, 3) and np.isfinite(mobile).all()
    with pytest.raises(FileNotFoundError, match="StanfordBunny"):
        debug_low_res.main(argv + ["--model", "bunny"])


def test_fidelity_and_helmet_profile_tools(tmp_path, capsys):
    """The two tools on the stand-in at --device cpu (the plain versions of
    both routes: no difference above 1e-3 may appear between them), and each
    fails naming a missing asset."""
    from bpt_tpu_torch.tools import fidelity, helmet_profile

    _write_teapot_stand_in(tmp_path / "models")
    common = ["--models-dir", str(tmp_path / "models"), "--device", "cpu", "--bounces", "2"]
    f = fidelity.main(["--model", "teapot", "--size", "16"] + common)
    assert "teapot 16x16 b=2 tris=16" in capsys.readouterr().out
    assert f["pct"] == f["bake_pct"] + f["flip_pct"] and 0.0 <= f["pct"] <= 100.0 and f["max"] >= f["mean"] >= 0.0
    rows = helmet_profile.main(["--model", "teapot", "--size", "8", "--frames", "2", "--iters", "1",
                                "--models-dir", str(tmp_path / "models"), "--device", "cpu"])
    assert [r["name"] for r in rows][-1] == "monolithic x2 b=4" and len(rows) == 7
    assert all(r["ms"] > 0 and r["mrays"] > 0 for r in rows)
    for main, asset in ((fidelity.main, "DamagedHelmet"), (helmet_profile.main, "DamagedHelmet")):
        with pytest.raises(FileNotFoundError, match=asset):
            main(["--model", "helmet", "--models-dir", str(tmp_path / "models"), "--device", "cpu"])
