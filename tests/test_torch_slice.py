"""The whole slice: Predictor.detect_batch against the JAX composition.

pixellink_tiny is initialised by JAX, its BN statistics and affines are
perturbed with seeded numpy values, and the variables are converted into
the port. The JAX side is the composition of ``infer.py:171-185``:
``model.apply`` + ``pixel_link_scores`` + vmapped ``pixellink_decode``
(plain XLA connected components), all float32 on the CPU. Tolerances:
logits within 1e-4; box counts equal; boxes within 1e-3 at label-map
resolution, i.e. 1e-3 * stride in pixels (or, at a min-area angle tie,
equal areas; see test_torch_decode.py).
Thresholds sit in the widest gap between sorted scores, so no pixel is
within float noise of one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.infer import pixel_link_scores as jax_scores
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.ops import decode as JD
from tensorflow_ocr_tpu_torch.config import InferConfig
from tensorflow_ocr_tpu_torch.infer import Predictor
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from test_torch_decode import assert_same_boxes
from test_torch_resnet import perturb_bn

torch.set_num_threads(1)
LOGIT_ATOL = 1e-4


def _gap_threshold(scores, lo, hi):
    """Midpoint of the widest gap between sorted scores in the [lo, hi]
    quantile range, and the gap's width."""
    s = np.sort(scores.ravel())
    i0, i1 = int(lo * len(s)), int(hi * len(s))
    gaps = np.diff(s[i0:i1])
    k = int(np.argmax(gaps))
    return float((s[i0 + k] + s[i0 + k + 1]) / 2), float(gaps[k])


def test_detect_batch_matches_jax_composition():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    jmodel = build_jax_model("pixellink_tiny", dtype=jnp.float32)
    variables = perturb_bn(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 96, 3), jnp.float32)), rng)
    jout = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
    jps, jls = map(np.asarray, jax_scores(jout))

    pred = Predictor("pixellink_tiny", weights=convert_variables(variables),
                     device="cpu", dtype=torch.float32,
                     infer=InferConfig(min_component_size=3))
    with torch.inference_mode():
        tout = pred.model(torch.from_numpy(images))
    for key in ("pixel_logits", "link_logits"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=0, atol=LOGIT_ATOL, err_msg=key)

    pred.pixel_thresh, pgap = _gap_threshold(jps, 0.5, 0.9)
    pred.link_thresh, lgap = _gap_threshold(jls, 0.2, 0.6)
    assert min(pgap, lgap) > 1e-4

    got = pred.detect_batch(images)

    def one(ps, ls):
        return JD.pixellink_decode(
            ps, ls, pixel_thresh=pred.pixel_thresh,
            link_thresh=pred.link_thresh, min_size=pred.min_size,
            max_components=pred.infer.max_components, use_pallas=False)

    jb, js, jv = map(np.asarray, jax.vmap(one)(jnp.asarray(jps),
                                               jnp.asarray(jls)))
    assert sum(len(b) for b in got) > 0
    for i in range(len(images)):
        # boxes leave scaled by the stride (4: exact in float32)
        assert len(got[i]) == int(jv[i].sum())
        assert_same_boxes(np.array(got[i]).reshape(-1, 4, 2) / pred.stride,
                          jb[i][jv[i]])


def test_predictor_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(device="cuda")
