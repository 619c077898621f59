"""The port's serving bundles (``tensorflow_ocr_tpu_torch/export.py``).

On the CPU in float32, with ``pixellink_tiny`` and ``east_tiny`` at
2 x 64x96:

- every bundle (maps only or with the decode; weights baked or external)
  round-trips through ``load_serving_bundle`` and equals the live path:
  the maps equal ``pixel_link_scores`` of the model's forward within
  1e-6 (the same operations, traced), the boxes equal
  ``Predictor.detect_batch``'s (map resolution x stride, corners within
  1e-4), EAST's candidates equal ``east_detect``'s;
- ``meta.json`` has JAX's keys, with ``torch_version`` in place of
  ``jax_version``, and the external program does not carry the weights;
- against JAX's ``save_serving_bundle`` of the same weights (its variables
  converted by ``models/convert.py``): the maps within 1e-4 (float32
  convs summed in another order), the boxes under
  tests/test_torch_decode.py ``assert_same_boxes``;
- the CC op ``tensorflow_ocr_tpu_torch::connected_components``: its fake
  implementation gives int32 labels of the mask's shape, and
  ``torch.library.opcheck`` passes on the CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import Config
from tensorflow_ocr_tpu.export import load_serving_bundle as jax_load
from tensorflow_ocr_tpu.export import save_serving_bundle as jax_save
from tensorflow_ocr_tpu.infer import Predictor as JaxPredictor
from tensorflow_ocr_tpu_torch import export as E
from tensorflow_ocr_tpu_torch.infer import Predictor, pixel_link_scores
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from tensorflow_ocr_tpu_torch.ops import decode as D
from tensorflow_ocr_tpu_torch.ops import kernels as K

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_decode import assert_same_boxes  # noqa: E402

torch.set_num_threads(1)
B, H, W = 2, 64, 96
JAX_META = {"model", "input", "with_decode", "weights", "platforms",
            "output_stride", "operating_point", "calibrated", "note"}


def _images(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(
        np.uint8)


def _pred(name, weights=None):
    p = Predictor(name, weights=weights, device="cpu", dtype=torch.float32)
    if name == "pixellink_tiny":  # components at these thresholds
        p.pixel_thresh, p.link_thresh, p.min_size = 0.5, 0.5, 2
    else:
        p.score_thresh = 0.5
    return p


def _run(tmp_path, pred, decode, bake):
    path = E.save_serving_bundle(str(tmp_path / f"{decode}_{bake}"), pred,
                                 B, H, W, with_decode=decode,
                                 bake_weights=bake)
    run, meta = E.load_serving_bundle(path)
    x = torch.from_numpy(_images()).float()
    out = run(x) if bake else run(E.serving_weights(pred), x)
    return path, meta, out


@pytest.mark.parametrize("bake", [True, False], ids=["baked", "external"])
@pytest.mark.parametrize("decode", [True, False], ids=["decode", "maps"])
def test_pixellink_bundle_equals_the_live_path(tmp_path, decode, bake):
    pred = _pred("pixellink_tiny")
    path, meta, out = _run(tmp_path, pred, decode, bake)
    assert set(meta) == JAX_META | {"torch_version"}
    assert meta["weights"] == ("baked" if bake else
                               f"external (port checkpoint: "
                               f"{pred.infer.checkpoint_path})")
    assert meta["platforms"] == ["cpu"] and meta["with_decode"] is decode
    assert meta["operating_point"] == {"pixel": 0.5, "link": 0.5,
                                       "min_component_size": 2}
    program = torch.export.load(os.path.join(path, E.PROGRAM_FILE))
    held = [*program.state_dict.values(), *program.constants.values()]
    held = sum(t.numel() * t.element_size() for t in held if
               isinstance(t, torch.Tensor))
    n_bytes = sum(t.numel() * 4 for t in pred.model.state_dict().values())
    assert (held >= n_bytes) is bake, (held, n_bytes)
    if not decode:
        with torch.no_grad():
            ps, ls = pixel_link_scores(pred.model(torch.from_numpy(
                _images())))
        np.testing.assert_allclose(out["pixel_scores"], ps, atol=1e-6)
        np.testing.assert_allclose(out["link_scores"], ls, atol=1e-6)
        return
    want = pred.detect_batch(_images())
    assert sum(len(w) for w in want) >= 2
    for i in range(B):
        got = out["boxes"][i][out["valid"][i]].numpy() * pred.stride
        np.testing.assert_allclose(got, np.stack(want[i]), atol=1e-4)


@pytest.mark.parametrize("bake", [True, False], ids=["baked", "external"])
def test_east_bundle_equals_east_detect(tmp_path, bake):
    pred = _pred("east_tiny")
    _, meta, out = _run(tmp_path, pred, True, bake)
    assert meta["operating_point"] == {"score": 0.5, "nms": 0.2}
    with torch.no_grad():
        o = pred.model(torch.from_numpy(_images()))
        q, s, v = D.east_detect(o["score"][..., 0], o["geometry"], 0.5)
    assert bool(v.any())
    assert torch.equal(out["valid"], v)
    np.testing.assert_allclose(out["scores"], s, atol=1e-6)
    np.testing.assert_allclose(out["quads"], q, atol=1e-4)


@pytest.mark.parametrize("decode", [True, False], ids=["decode", "maps"])
def test_bundle_against_jax_s(tmp_path, decode):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.infer.checkpoint_path = str(tmp_path / "none")
    cfg.infer.pixel_conf_threshold = cfg.infer.link_conf_threshold = 0.5
    cfg.infer.min_component_size = 2
    jp = JaxPredictor(cfg)
    # JAX's serving program in float32, as the port's below
    from tensorflow_ocr_tpu.models import build_model
    jp.model = build_model("pixellink_tiny", dtype=jnp.float32)
    jax_path = jax_save(str(tmp_path / "jax"), jp, B, H, W,
                        with_decode=decode, platforms=("cpu",))
    run, meta = jax_load(jax_path)
    images = _images(1).astype(np.float32)
    want = {k: np.asarray(v) for k, v in run(jp.variables, images).items()}
    pred = _pred("pixellink_tiny",
                 convert_variables(jax.device_get(jp.variables)))
    path = E.save_serving_bundle(str(tmp_path / "port"), pred, B, H, W,
                                 with_decode=decode)
    prun, pmeta = E.load_serving_bundle(path)
    got = {k: v.numpy() for k, v in
           prun(E.serving_weights(pred), torch.from_numpy(images)).items()}
    assert set(got) == set(want)
    assert pmeta["operating_point"] == meta["operating_point"]
    assert set(pmeta) - {"torch_version"} == set(meta) - {"jax_version"}
    if not decode:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
        return
    assert want["valid"].sum() >= 2
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["sizes"], want["sizes"])
    for i in range(B):
        assert_same_boxes(got["boxes"][i][got["valid"][i]],
                          want["boxes"][i][want["valid"][i]])


def test_cc_op_fake_shape_and_opcheck():
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.RandomState(0)
    mask = torch.from_numpy(rng.rand(2, 12, 20) > 0.5)
    edges = D.link_adjacency(mask, torch.from_numpy(
        rng.rand(2, 12, 20, 8).astype(np.float32)), 0.5)
    with FakeTensorMode() as mode:
        out = K.connected_components_op(mode.from_tensor(edges),
                                        mode.from_tensor(mask))
    assert out.shape == mask.shape and out.dtype == torch.int32
    torch.library.opcheck(K.connected_components_op, (edges, mask))
    assert torch.equal(
        torch.ops.tensorflow_ocr_tpu_torch.connected_components(edges, mask),
        K.connected_components_reference(edges, mask))


def test_export_model_torch_script(tmp_path, monkeypatch):
    """scripts/export_model_torch.py: a port checkpoint's EMA weights and
    its calibrated operating point, maps-only, baked; JAX's flags."""
    from tensorflow_ocr_tpu_torch.config import Config as PortConfig
    from tensorflow_ocr_tpu_torch.train import trainer as T
    from tensorflow_ocr_tpu_torch.train.calibrate import save_operating_point

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mod = _load(repo, "export_model_torch")
    cfg = PortConfig()
    cfg.model.name = "pixellink_tiny"
    state = T.create_train_state(cfg, "cpu")
    with torch.no_grad():
        for v in state.ema.values():
            v.add_(0.01)
    ck = str(tmp_path / "ck")
    T.save_checkpoint(ck, state)
    save_operating_point(ck, {"pixel": 0.61, "link": 0.42})
    out = mod.main(["--checkpoint", ck, "--model", "pixellink_tiny",
                    "--out", str(tmp_path / "b"), "--batch", "1", "--size",
                    "64", "--maps-only", "--bake-weights", "--device", "cpu"])
    run, meta = E.load_serving_bundle(out)
    assert meta["calibrated"] and meta["weights"] == "baked"
    assert meta["operating_point"]["pixel"] == 0.61
    pred = Predictor("pixellink_tiny", checkpoint_path=ck, device="cpu")
    x = torch.from_numpy(_images()[:1, :64, :64])
    with torch.no_grad():
        ps, _ = pixel_link_scores(pred.model(x))
    np.testing.assert_allclose(run(x.float())["pixel_scores"], ps.float(),
                               atol=1e-6)
    # JAX's flags, but --platforms (a torch program has one device: --device)
    assert _flags(monkeypatch, _load(repo, "export_model").main, ()) - \
        {"platforms"} <= _flags(monkeypatch, mod.main, ([],))


def _load(repo, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(repo, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(monkeypatch, main, args):
    """The option names of the parser ``main`` builds (not run)."""
    import argparse

    seen = set()

    class Stop(Exception):
        pass

    def grab(self, *a, **k):
        seen.update(x.dest for x in self._actions)
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Stop):
            main(*args)
    return seen
