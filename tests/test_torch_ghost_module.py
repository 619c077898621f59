"""GhostBottleneck and the ghost ResNet against JAX's (models/resnet.py).

A unit of N=2, H=24, W=16, db 8, Co 32 (pick_gh: bands of 8 rows, 3 an
image), identity and projection shortcuts, float32, BN parameters and
statistics perturbed: train mode (JAX's Pallas kernels interpreted) with
the running-statistics update, the gradients and dx; eval mode (the
running-statistics affine after the products). Tolerances: 1e-4 of the
largest value (the unit tests of test_torch_ghost.py hold the op to 1e-5
and 1e-4; the module adds the running update). Then the call-time unit
choice at 512x512 and the weight bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.models import resnet as JR
from tensorflow_ocr_tpu.ops import pallas_unit as PU
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models import resnet as TR
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_variables,
    load_variables,
)
from test_torch_bottleneck import close, grads_by_torch_key, nchw, nhwc
from test_torch_resnet import perturb_bn
from test_torch_step import numpy_init

torch.set_num_threads(1)


@pytest.fixture
def interpret():
    PU.set_interpret(True)
    yield
    PU.set_interpret(False)


def unit_case(depth_in, seed):
    rng = np.random.RandomState(seed)
    # a unit's input is a relu output: >= 0, with exact zeros
    x = np.maximum(rng.randn(2, 24, 16, depth_in), 0).astype(np.float32)
    g = rng.randn(2, 24, 16, 32).astype(np.float32)
    ref = JR.GhostBottleneck(32, 8, dtype=jnp.float32)
    variables = perturb_bn(ref.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x)), rng)
    port = load_variables(TR.GhostBottleneck(depth_in, 32, 8), variables)
    assert port.band_height((2, depth_in, 24, 16)) == 8
    return x, g, ref, variables, port


@pytest.mark.parametrize("depth_in", [32, 16], ids=["identity", "proj"])
def test_ghost_bottleneck_train_matches_jax(interpret, depth_in):
    x, g, ref, variables, port = unit_case(depth_in, depth_in)

    def loss(params, xin):
        y, mut = ref.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           xin, train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut)

    (_, (want, mutated)), (jgrads, jdx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    tx = nchw(x).requires_grad_()
    got = port(tx, train=True)
    close(nhwc(got), want, 1e-4, "y")
    for key, value in convert_variables(
            {"batch_stats": mutated["batch_stats"]}).items():
        close(port.state_dict()[key], value, 1e-4, key)
    (got * nchw(g)).sum().backward()
    for key, value in grads_by_torch_key(jgrads).items():
        close(dict(port.named_parameters())[key].grad, value, 1e-4, key)
    close(nhwc(tx.grad), jdx, 1e-4, "dx")


@pytest.mark.parametrize("depth_in", [32, 16], ids=["identity", "proj"])
def test_ghost_bottleneck_eval_matches_jax(depth_in):
    x, g, ref, variables, port = unit_case(depth_in, depth_in + 1)
    want, jvjp = jax.vjp(lambda v: ref.apply(v, jnp.asarray(x)), variables)
    (jgrads,) = jvjp(jnp.asarray(g))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = port(nchw(x), train=False)
    close(nhwc(got), want, 1e-4, "y")
    (got * nchw(g)).sum().backward()
    for key, value in grads_by_torch_key(jgrads["params"]).items():
        close(dict(port.named_parameters())[key].grad, value, 1e-4, key)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k  # eval leaves the stats alone


def test_ghost_bottleneck_off_its_shapes_is_a_bottleneck():
    """Where pick_gh admits no band height, the unit is a plain
    Bottleneck in train and eval mode, as JAX builds one there."""
    torch.manual_seed(0)
    unit = TR.GhostBottleneck(32, 32, 8)
    plain = TR.Bottleneck(32, 32, 8, 1)
    plain.load_state_dict(unit.state_dict())
    x = torch.relu(torch.randn(2, 32, 12, 12))
    assert unit.band_height(x.shape) is None
    for train in (False, True):
        torch.testing.assert_close(unit(x, train), plain(x, train))
    assert unit.state_dict().keys() == plain.state_dict().keys()


def test_resnet50_ghost_units_at_512():
    """At 512x512 (batch 32) JAX makes 5 ghost units (block1_unit1-2,
    block2_unit1-3, bands of 8 rows) and 8 stride-1 plain units; the
    port's GhostBottlenecks make the same choice at call time."""
    bb = build_model("pixellink_resnet50", bottleneck_impl="ghost").backbone
    ghost, plain = {}, []
    cin = 64
    for b, names in enumerate(bb.blocks):
        s = 128 >> b
        for name in names:
            unit = getattr(bb, name)
            depth, db = (unit.conv3.conv.out_channels,
                         unit.conv1.conv.out_channels)
            if isinstance(unit, TR.GhostBottleneck):
                gh = unit.band_height((32, cin, s, s))
                assert (gh is not None) == JR.GhostBottleneck.supported(
                    (32, s, s, cin), depth, db), name
                if gh is None:
                    plain.append(name)
                else:
                    ghost[name] = gh
            else:
                assert unit.stride == 2, name
            cin = depth
    assert ghost == {"block1_unit1": 8, "block1_unit2": 8,
                     "block2_unit1": 8, "block2_unit2": 8,
                     "block2_unit3": 8}
    assert len(plain) == 8
    assert (bb.state_dict().keys()
            == build_model("pixellink_resnet50").backbone.state_dict().keys())


def test_jax_ghost_model_loads_strictly(monkeypatch):
    """The variables of JAX's pixellink_resnet50 with its ghost units
    (at 96x96, where block1's units are ghost units) load into the port's
    ghost model with strict=True."""
    monkeypatch.delenv("OCR_GHOST_UNITS", raising=False)
    monkeypatch.setattr(JR, "GHOST_BOTTLENECKS", True)
    monkeypatch.setattr(JR, "FUSED_BOTTLENECKS", False)
    jmodel = build_jax_model("pixellink_resnet50", dtype=jnp.float32)
    variables = numpy_init(jmodel, 96, np.random.RandomState(0))
    port = build_model("pixellink_resnet50", dtype=torch.float32,
                       bottleneck_impl="ghost")
    load_variables(port, variables)
    with torch.no_grad():
        port(torch.zeros(1, 96, 96, 3))
