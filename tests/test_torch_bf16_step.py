"""One bfloat16 train step of the port against one of JAX's, on the CPU.

``pixellink_resnet50`` at 128^2, batch 2, both sides in bfloat16 as they
ship (JAX's BatchNorm in bf16, no ``f32_batchnorm``), the "xla"
bottleneck that the held-out recipe trains, from one state: the converted
weights of test_torch_bf16.py (seeded numpy values, BN perturbed, the
logits convs rescaled) and Adam's empty moments. JAX runs
``make_train_step`` on a 1-device mesh; the port ``train_step``.

After the step the BN running statistics (``m·old + (1 − m)·batch``, the
batch statistics of the bf16 forward) of every layer agree within
``STATS_TOL`` = 5e-3 of the buffer's largest value, and their mean error
over the layers within 1e-3: the noise that bf16 puts into the batch
statistics is what sets these. Measured: the largest 2.17e-3
(``block4_unit1.conv1``'s mean), the mean 2.9e-4 over the 122 buffers
(test_torch_bf16.py
holds the same statistics of the forward against the float32 truth,
within 1.5x of JAX's own error). The step's losses are not compared
term by term here: at random init a bf16 train step's OHEM loss moves by
tens of percent of a link direction between two roundings (test_torch_
bf16.py holds the loss against the truth); the positives counted are
equal and the model losses within 2% (measured 16.5962 against
16.6003).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.parallel.mesh import make_mesh
from tensorflow_ocr_tpu.train import optim as JOptim
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_bf16 import f32_batchnorm, rescale_logits
from test_torch_step import numpy_init, scene_batch

torch.set_num_threads(1)
MODEL, SIZE = "pixellink_resnet50", 128
STATS_TOL, STATS_MEAN_TOL = 5e-3, 1e-3


def test_bn_running_statistics_after_a_bf16_step_match_jax():
    rng = np.random.RandomState(16)
    batch = scene_batch(rng, 2, SIZE)
    j32 = build_jax_model(MODEL, dtype=jnp.float32)
    j16 = build_jax_model(MODEL, dtype=jnp.bfloat16)
    variables = numpy_init(j32, SIZE, rng)
    with f32_batchnorm():
        variables = rescale_logits(variables, jax.jit(j32.apply)(
            variables, jnp.asarray(batch["images"])))

    jcfg = JConfig()
    jcfg.data.input_size = SIZE
    jcfg.train.donate_state = False
    tx = JOptim.make_optimizer(jcfg.train,
                               weight_decay=jcfg.model.weight_decay)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), ema_params=params)
    mesh = make_mesh(1)
    jstate, jm = JT.make_train_step(j16, tx, jcfg, mesh)(
        jstate, JT.device_batch(batch, mesh, want_east=False))

    cfg = Config()
    cfg.data.input_size = SIZE
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.model.bottleneck_impl == "xla"
    state = TT.create_train_state(cfg, device="cpu",
                                  weights=convert_variables(variables))
    m = TT.train_step(state, TT.to_device(batch, "cpu"), cfg,
                      TT.make_loss_fn(cfg))

    assert float(m["n_pos"]) == float(jm["n_pos"]) > 0
    np.testing.assert_allclose(float(m["model_loss"]),
                               float(jm["model_loss"]), rtol=2e-2)
    got = state.model.state_dict()
    errs = {}
    for key, want in convert_variables(
            {"batch_stats": jstate.batch_stats}).items():
        want = want.numpy().astype(np.float64)
        errs[key] = (np.abs(got[key].double().numpy() - want).max()
                     / np.abs(want).max())
    worst = max(errs, key=errs.get)
    mean = float(np.mean(list(errs.values())))
    print(f"BN running statistics after one bf16 step, port against JAX: "
          f"largest {errs[worst]:.3e} ({worst}), mean {mean:.3e} over "
          f"{len(errs)}; model loss {float(m['model_loss']):.4f} against "
          f"{float(jm['model_loss']):.4f}")
    assert len(errs) == 2 * sum(k.endswith("running_var") for k in got)
    assert errs[worst] <= STATS_TOL, worst
    assert mean <= STATS_MEAN_TOL
