"""The port's neural pseudo-label drivers (adgs_tpu_torch/scripts/
generate_{depth,flow,semantic}.py) against the JAX package's
(scripts/generate_*.py), with the same deterministic torch stand-ins for
the networks monkeypatched into both (the checkpoints are not in the
repository):
  - on tests/test_data_cli.py's KITTI scene and tests/test_readers_multi.py's
    Waymo and nuScenes scenes, depth, object masks (re-detection every
    other frame, propagation in between, chunks without a detection), sky
    masks and flow packages: every written file bitwise equal, and the
    port's validate_scene accepts the scene;
  - without the external packages, both drivers exit with the same
    contract text.
The JAX flow driver reads nuScenes intrinsics as [fx, fy, cx, cy], while
convert_nuscenes writes (and the readers take) 3x3 matrices, on which it
fails; the port reads the 3x3 layout, and the JAX driver is given its
copy's intrinsics in its own layout (the same matrices).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from adgs_tpu_torch.scripts import generate_depth as tdepth
from adgs_tpu_torch.scripts import generate_flow as tflow
from adgs_tpu_torch.scripts import generate_semantic as tsem
from adgs_tpu_torch.scripts import validate_scene as tvalidate
from tests.test_data_cli import make_kitti_scene
from tests.test_readers_multi import make_nuscenes_scene, make_waymo_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAKERS = {"kitti": make_kitti_scene, "waymo": make_waymo_scene,
          "nuscenes": make_nuscenes_scene}


def _jax_driver(name):
    """scripts/<name>.py loaded as a module (its main() reads sys.argv)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class DepthNet:
    def infer_image(self, raw, input_size):
        raw = raw.astype(np.float32)
        return raw[..., 0] * 0.5 + raw[..., 2] * 0.25 + input_size * 1e-3


def tracker(video, queries):
    """[1, T, 3, H, W], [1, N, 3] -> tracks [1, T, N, 2], vis [1, T, N]."""
    shift = video[0].mean(dim=(1, 2, 3))                         # [T]
    xy = queries[0, :, 1:3]
    tracks = xy[None] + shift[:, None, None] * 0.01
    vis = ((xy[None, :, 0] * 7 + xy[None, :, 1] * 3 + shift[:, None])
           % 5) > 2
    return tracks[None], vis[None]


class VideoPredictor:
    def init_state(self, video_path):
        return {"masks": {}}

    def reset_state(self, state):
        state["masks"] = {}

    def add_new_mask(self, state, frame, obj_id, mask):
        state["masks"][obj_id] = mask.clone()

    def propagate_in_video(self, state, max_frame_num_to_track,
                           start_frame_idx):
        ids = sorted(state["masks"])
        for k in range(max_frame_num_to_track + 1):
            logits = torch.stack([
                torch.roll(state["masks"][i].float(), k, dims=1) * 2 - 1
                for i in ids])[:, None]
            yield start_frame_idx + k, ids, logits


class ImagePredictor:
    def set_image(self, arr):
        self.arr = arr

    def predict(self, box, multimask_output):
        h, w = self.arr.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        masks = [((xx >= b[0]) & (xx < b[2]) & (yy >= b[1]) & (yy < b[3])
                  & (self.arr[..., 0] > 100)).astype(np.float32)
                 for b in box]
        return np.stack(masks)[:, None], None, None


def detect_boxes(processor, grounding, image, text, device):
    arr = np.asarray(image)
    w, h = image.size
    if int(arr.sum()) % 3 == 0:
        return np.zeros((0, 4), np.float32), []
    boxes = [[0.1 * w, 0.2 * h, 0.6 * w, 0.9 * h]]
    if "sky" not in text:
        boxes.append([0.5 * w, 0.0, w, 0.5 * h])
    return np.asarray(boxes, np.float32), ["thing"] * len(boxes)


def _stand_ins(monkeypatch, mods):
    depth, flow, sem = mods
    monkeypatch.setattr(depth, "load_model", lambda *a, **k: DepthNet())
    monkeypatch.setattr(flow, "load_cotracker", lambda *a, **k: tracker)
    monkeypatch.setattr(sem, "load_models", lambda *a, **k: (
        VideoPredictor(), ImagePredictor(), None, None))
    monkeypatch.setattr(sem, "detect_boxes", detect_boxes)


def _run_jax(monkeypatch, mod, args):
    monkeypatch.setattr(sys, "argv", ["driver"] + args)
    mod.main()


def _label_runs(scene):
    """(driver index, arguments) of the label chain on `scene`."""
    return [(0, ["--img-path", os.path.join(scene, "image"),
                 "--outdir", os.path.join(scene, "depth"),
                 "--input-size", "64"]),
            (2, [scene, "--step", "2"]),
            (2, [scene, "--text", "sky", "--name", "sky", "--step", "2"]),
            (1, [scene, "--step", "1"])]


def _files(root):
    out = {}
    for d in ("depth", "semantic", "sky", "flow"):
        for dirpath, _, files in os.walk(os.path.join(root, d)):
            for f in files:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = p
    return out


@pytest.mark.parametrize("dataset", ["kitti", "waymo", "nuscenes"])
def test_generators_bitwise(tmp_path, monkeypatch, dataset):
    jax_mods = [_jax_driver(n) for n in
                ("generate_depth", "generate_flow", "generate_semantic")]
    port_mods = [tdepth, tflow, tsem]
    _stand_ins(monkeypatch, jax_mods)
    _stand_ins(monkeypatch, port_mods)
    roots = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        MAKERS[dataset](root)
        # the flow packages come from the drivers, not the fixture
        for dirpath, _, files in os.walk(os.path.join(root, "flow")):
            for f in files:
                os.remove(os.path.join(dirpath, f))
        if dataset == "kitti":
            # the converter's pose layout (3x3 R, 3-vector T), which the
            # flow packages carry on into validate_scene's check
            poses = dict(np.load(os.path.join(root, "poses.npz")))
            poses["R"], poses["T"] = poses["R"][:, :3, :3], poses["T"][:, :3]
            np.savez(os.path.join(root, "poses.npz"), **poses)
        roots[side] = root
        for i, args in _label_runs(root):
            if side == "jax" and i == 1 and dataset == "nuscenes":
                meta = dict(np.load(os.path.join(root, "meta.npz")))
                K = meta["K"]
                meta["K"] = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2],
                                      K[:, 1, 2]], axis=1)
                np.savez(os.path.join(root, "meta.npz"), **meta)
            if side == "jax":
                _run_jax(monkeypatch, jax_mods[i],
                         args + (["--device", "cpu"] if i else []))
            else:
                port_mods[i].main(args + ["--device", "cpu"])
    want, got = _files(roots["jax"]), _files(roots["port"])
    assert sorted(got) == sorted(want)
    n_flow = 0
    for rel, path in want.items():
        if rel.endswith(".npz"):
            with np.load(path, allow_pickle=True) as w, \
                    np.load(got[rel], allow_pickle=True) as g:
                assert len(g["flow"]) == len(w["flow"]), rel
                for a, b in zip(g["flow"], w["flow"]):
                    for x, y in zip(a, b):
                        np.testing.assert_array_equal(x, y, err_msg=rel)
                        assert np.asarray(x).dtype == np.asarray(y).dtype
                n_flow += len(w["flow"])
        else:
            a, b = np.load(got[rel]), np.load(path)
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(a, b, err_msg=rel)
    assert n_flow > 0
    masks = [np.load(p) for r, p in got.items() if r.startswith("semantic")]
    assert any(m.max() > 0 for m in masks) and any(m.max() == 0
                                                   for m in masks)
    split = ["--split_mode", "nvs-75"] if dataset == "kitti" else []
    tvalidate.main([roots["port"], "--device", "cpu"] + split)   # no exit


def test_missing_models_exit_with_the_contract(tmp_path, monkeypatch):
    jax_mods = [_jax_driver(n) for n in
                ("generate_depth", "generate_flow", "generate_semantic")]

    def offline(*a, **k):
        raise RuntimeError("no hub cache")
    # CoTracker3 comes through torch.hub: stand in for an absent cache
    monkeypatch.setattr(torch.hub, "load", offline)
    calls = [lambda m: m.load_model("vitl", str(tmp_path), "cpu"),
             lambda m: m.load_cotracker("cpu"),
             lambda m: m.load_models(str(tmp_path / "sam.pt"), "cfg.yaml",
                                     "cpu")]
    for call, jm, pm in zip(calls, jax_mods, (tdepth, tflow, tsem)):
        assert pm.CONTRACT == jm.CONTRACT
        with pytest.raises(SystemExit) as ex:
            call(pm)
        assert pm.CONTRACT in str(ex.value.code)
    with pytest.raises(SystemExit) as ex:
        jax_mods[0].load_model("vitl", str(tmp_path))
    assert tdepth.CONTRACT in str(ex.value.code)
