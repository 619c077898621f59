"""The port's eval hook (train/eval_hook.py) against JAX's
``EvalDuringTraining``, and calibration through it against JAX's.

A 4-image synthetic directory (JAX's ``make_synthetic_dataset``, noise and
white rotated boxes, 600x560, so that the ground truth is scaled unevenly)
is staged by both hooks: the images equal byte for byte, the scaled
ground truth equal.

With ``pixellink_tiny`` and ``east_tiny`` (seeded numpy Flax variables,
converted; float32 on both sides, JAX's BatchNorm in float32 by the
``f32_batchnorm`` fixture) at 512^2, P/R/F equal at two operating points:
one in the widest gap of the score maps, one that lets every pixel
through (PixelLink: the whole map is one component, over the decode's
foreground budget, so both hooks re-decode at full budget and count
one ``overflow_retries`` each).

With random weights no box matches the ground truth, so the matching and
the calibration are held with an oracle in place of the network, on both
sides: the pixel and link logits are affine in the mean brightness of
each 4x4 cell, so the white boxes are found and the thresholds move their
edges. There P/R/F equal JAX's at two operating points with TPs, and
``calibrate_thresholds`` picks JAX's operating point with JAX's F.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.data.icdar import make_synthetic_dataset
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.train import calibrate as JC
from tensorflow_ocr_tpu.train.eval_hook import EvalDuringTraining as JHook
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models.convert import load_variables
from tensorflow_ocr_tpu_torch.train import calibrate as TC
from tensorflow_ocr_tpu_torch.train import eval_hook as TE
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_infer_east import gap_threshold
from test_torch_step import numpy_init

torch.set_num_threads(1)
SIZE = 512
KEYS = ("precision", "recall", "fmean", "n_gt", "tp", "fp")


@pytest.fixture(scope="module")
def val_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hook_val"))
    make_synthetic_dataset(path, num_images=4, size=(560, 600), seed=5)
    return path


def configs(name):
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.model.name = name
        c.data.input_size = SIZE
    cfg.model.compute_dtype = "float32"
    return jcfg, cfg


def port_state(model):
    """The fields of a TrainState that the hook reads."""
    return SimpleNamespace(
        step=torch.zeros((), dtype=torch.int64), model=model,
        ema={n: p.detach().clone() for n, p in model.named_parameters()})


def jax_state(variables):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return SimpleNamespace(
        params=params, ema_params=params,
        batch_stats=jax.tree_util.tree_map(
            jnp.asarray, variables.get("batch_stats", {})))


def same(got, want):
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}


def test_staged_images_and_gt_equal_jax(val_dir):
    jcfg, cfg = configs("pixellink_tiny")
    jh, th = JHook(jcfg, val_dir, max_images=4), TE.EvalDuringTraining(
        cfg, val_dir, max_images=4)
    assert th.images.shape == (4, SIZE, SIZE, 3)
    np.testing.assert_array_equal(th.images, jh.images)
    assert len(th.gts) == len(jh.gts) == 4
    for (g, i), (jg, ji) in zip(th.gts, jh.gts):
        assert g.dtype == jg.dtype == np.float32
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(i, ji)
    assert th.min_size == jh.min_size and th.stride == jh.stride


def test_empty_directory_has_no_images(tmp_path):
    _, cfg = configs("pixellink_tiny")
    hook = TE.EvalDuringTraining(cfg, str(tmp_path))
    assert hook.images is None
    assert hook(None, None) == {}


def real_models(name, seed):
    rng = np.random.RandomState(seed)
    jmodel = build_jax_model(name, dtype=jnp.float32)
    variables = numpy_init(jmodel, 64, rng)
    model = load_variables(build_model(name, dtype=torch.float32),
                           variables)
    return jmodel, variables, model


@pytest.mark.usefixtures("f32_batchnorm")
def test_pixellink_tiny_prf_and_overflow_equal_jax(val_dir):
    jcfg, cfg = configs("pixellink_tiny")
    jmodel, variables, model = real_models("pixellink_tiny", 3)
    jh, th = JHook(jcfg, val_dir), TE.EvalDuringTraining(cfg, val_dir)
    jst, st = jax_state(variables), port_state(model)
    out = jmodel.apply(variables, jnp.asarray(jh.images))
    from tensorflow_ocr_tpu.infer import pixel_link_scores

    ps, ls = (np.asarray(t) for t in pixel_link_scores(out))
    for pt, lt in ((gap_threshold(ps), gap_threshold(ls)), (0.0, 0.0)):
        want = jh(jmodel, jst, pixel_thresh=pt, link_thresh=lt)
        got = th(model, st, pixel_thresh=pt, link_thresh=lt)
        same(got, want)
        assert got["tp"] + got["fp"] > 0
    assert th.overflow_retries == jh.overflow_retries == 1


@pytest.mark.usefixtures("f32_batchnorm")
def test_east_tiny_prf_equal_jax(val_dir):
    jcfg, cfg = configs("east_tiny")
    jmodel, variables, model = real_models("east_tiny", 4)
    # two images: the host NMS of a random score map is the slow part
    jh, th = (JHook(jcfg, val_dir, max_images=2),
              TE.EvalDuringTraining(cfg, val_dir, max_images=2))
    jst, st = jax_state(variables), port_state(model)
    score = np.asarray(jmodel.apply(variables,
                                    jnp.asarray(jh.images))["score"])
    for stt, nt in ((gap_threshold(score), 0.2),
                    (gap_threshold(score, 0.2, 0.5), 0.3)):
        want = jh(jmodel, jst, score_thresh=stt, nms_thresh=nt)
        got = th(model, st, score_thresh=stt, nms_thresh=nt)
        same(got, want)
        assert got["fp"] > 0


# the oracle: logits affine in each 4x4 cell's mean brightness
PIXEL_SLOPE, LINK_SLOPE = 7.3, 5.1


class JaxOracle:
    def apply(self, variables, images):
        n, h, w, _ = images.shape
        p = images.astype(jnp.float32).mean(-1) / 255.0
        p = p.reshape(n, h // 4, 4, w // 4, 4).mean((2, 4))[..., None]
        z = jnp.zeros_like(p)
        pix = jnp.concatenate([z, PIXEL_SLOPE * (p - 0.5)], -1)
        link = jnp.concatenate([z, LINK_SLOPE * (p - 0.6)] * 8, -1)
        return {"pixel_logits": pix, "link_logits": link}


class TorchOracle(torch.nn.Module):
    def forward(self, images, train=False):
        n, h, w, _ = images.shape
        p = images.float().mean(-1) / 255.0
        p = p.reshape(n, h // 4, 4, w // 4, 4).mean((2, 4))[..., None]
        z = torch.zeros_like(p)
        pix = torch.cat([z, PIXEL_SLOPE * (p - 0.5)], -1)
        link = torch.cat([z, LINK_SLOPE * (p - 0.6)] * 8, -1)
        return {"pixel_logits": pix, "link_logits": link}


@pytest.fixture
def oracle_hooks(val_dir, monkeypatch):
    monkeypatch.setattr(TE, "build_model", lambda *a, **k: TorchOracle())
    jcfg, cfg = configs("pixellink_tiny")
    st = port_state(torch.nn.Module())
    jst = SimpleNamespace(params={}, ema_params={}, batch_stats={})
    return (jcfg, JHook(jcfg, val_dir), jst), (cfg, TE.EvalDuringTraining(
        cfg, val_dir), st)


def test_oracle_prf_equal_jax(oracle_hooks):
    (_, jh, jst), (_, th, st) = oracle_hooks
    for pt, lt in ((0.8, 0.8), (0.6, 0.5)):
        want = jh(JaxOracle(), jst, pixel_thresh=pt, link_thresh=lt)
        got = th(None, st, pixel_thresh=pt, link_thresh=lt)
        same(got, want)
        assert got["tp"] > 0
    # the cached forward gives the numbers of a forward per call
    with th.cached_forward():
        cached = th(None, st, pixel_thresh=0.6, link_thresh=0.5)
        assert th._cache is not None
    assert th._cache is None
    same(cached, got)


def test_calibration_picks_jax_operating_point(oracle_hooks, tmp_path):
    (jcfg, jh, jst), (cfg, th, st) = oracle_hooks
    want = JC.calibrate_thresholds(JaxOracle(), jst, jcfg, "/unused",
                                   hook=jh)
    got = TC.calibrate_thresholds(None, st, cfg, "/unused", hook=th)
    assert got == want and got["fmean"] > 0
    TC.calibrate_and_store(None, st, cfg, "/unused", str(tmp_path), hook=th)
    assert TC.load_operating_point(str(tmp_path)) == dict(want, step=0)
